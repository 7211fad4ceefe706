#!/usr/bin/env python3
"""Main-path staged tiles/s of two checkouts of the port, in turns.

The main path of chip_smoke.py: TileEngine on yolo11l at 640 px with
seeded weights, README preprocessing (zscale + min-max), batches of 32
synthetic 640 px tiles staged on the card, in bf16 and (with --int8)
int8, calibrated on four of the tiles as chip_smoke.py's int8 phase does.
Each measurement runs in a fresh subprocess that imports the port of one
checkout; the checkouts take turns A B B A, `--rounds` times.  Prints the
card's name and power limit, every run's tiles/s and, per checkout and
mode, the median.

Run from the repository root on a CUDA card:
    python3 scripts/torch_ab_staged.py --a <parent checkout> --b . [--int8]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BATCH, BATCHES, SIZE, REPEATS = 32, 3, 640, 3


def child(root: str, modes: list[str]) -> None:
    """One measurement in this process: staged tiles/s of each mode, the
    best of REPEATS passes over BATCHES staged batches, as one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from caesar_yolo_tpu_torch.models import quant
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
    from caesar_yolo_tpu_torch.parallel.engine import TileEngine
    from caesar_yolo_tpu_torch.utils.synth import make_mosaic

    tiles = np.stack([make_mosaic(SIZE, SIZE, n_sources=25, noise_sigma=0.1,
                                  seed=1000 + i)[0]
                      for i in range(BATCH * BATCHES)])[..., None]
    pre = build_preprocessor(zscale_stretch=True, normalize_minmax=True)
    model = init_weights(build_model("yolo11l"), seed=0)
    kw = dict(preprocessor=pre, img_size=SIZE, score_thr=1e-3, iou_thr=0.5,
              pre_nms=512)
    out = {}
    for mode in modes:
        if mode == "int8":
            calib = quant.calibration_inputs_from_tiles(
                tiles[:4], preprocessor=pre, img_size=SIZE)
            engine = TileEngine(quant.quantize_model(model, calib), **kw)
        else:
            engine = TileEngine(model, **kw)
        staged = [engine.put_tiles(tiles[i * BATCH:(i + 1) * BATCH])
                  for i in range(BATCHES)]
        engine.process_async(staged[0])
        torch.cuda.synchronize()
        runs = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            for st in staged:
                engine.process_async(st)
            torch.cuda.synchronize()
            runs.append(BATCHES * BATCH / (time.perf_counter() - t0))
        out[mode] = max(runs)
    print(json.dumps(out), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--a", help="checkout A (the parent)")
    parser.add_argument("--b", help="checkout B (the change)")
    parser.add_argument("--int8", action="store_true")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    modes = ["bf16"] + (["int8"] if args.int8 else [])
    if args.child:
        child(args.child, modes)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    runs = {"A": [], "B": []}
    for _ in range(args.rounds):
        for side in ("A", "B", "B", "A"):
            root = args.a if side == "A" else args.b
            cmd = [sys.executable, os.path.abspath(__file__), "--child", root]
            if args.int8:
                cmd.append("--int8")
            res = subprocess.run(cmd, capture_output=True, text=True)
            if res.returncode != 0:
                print(res.stdout, res.stderr, flush=True)
                return 1
            got = json.loads(res.stdout.strip().splitlines()[-1])
            runs[side].append(got)
            print(f"{side} ({root}): " + ", ".join(
                f"{m} {v:.2f} tiles/s" for m, v in got.items()), flush=True)
    for side in ("A", "B"):
        print(f"{side} median: " + ", ".join(
            f"{m} {statistics.median(r[m] for r in runs[side]):.2f} tiles/s"
            for m in modes), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
