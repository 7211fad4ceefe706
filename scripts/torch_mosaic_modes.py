"""Mosaic tiles/s of the port's tiled CLI by device-tiling mode, with the
wall split by phase, on one card.

The mosaic phase of chip_smoke.py (a seeded 2560x2560 FITS mosaic with a
NaN border, yolo11l@640 bf16 with seeded weights, 512 px tiles at step
0.5, batches of 32, bkg + chan3 + min-max) run `--rounds` times in each
mode, in turns, after one warm-up run of each:
  auto    the default (this checkout: the whole mosaic on the card)
  off     streamed windowed reads
  band    one full-width band a grid row (the cap at one band's bytes)
  global  auto with --preproc_context=global
A checkout from before device-resident tiling takes only `auto` (which
streams there).  Each run prints one JSON line: tiles/s from the call to
the written catalog, the path taken, the pixel bytes shipped, the
SFinder's runtime and the setup before it (weights load, model build),
and its phase times and worker sums; the last line is the medians and
quartiles of each mode.

    python3 scripts/torch_mosaic_modes.py [--repo DIR] [--modes auto,off]
        [--rounds 3]

--repo runs another checkout's package (e.g. a `git archive` of the
parent), so that two versions are compared in one call, in turns.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

SIZE, TILE, BATCH = 2560, 512, 32
CHAIN = ["--preprocessing", "--subtract_bkg", "--chan3_preproc",
         "--sigma_clip_baseline=0", "--sigma_clip_low=1",
         "--sigma_clip_up=20", "--normalize_minmax", "--norm_min=0",
         "--norm_max=255"]
TILED = ["--split_img_in_tiles", f"--tile_xsize={TILE}",
         f"--tile_ysize={TILE}", "--tile_xstep=0.5", "--tile_ystep=0.5",
         "--max_ntasks_per_worker=1000", f"--batch_size={BATCH}"]
MODES = {"auto": [], "off": ["--device_tiling=off"], "band": [],
         "global": ["--preproc_context=global"]}


def run_mode(mode: str, flags: list[str]) -> dict:
    """One tiled run in the given mode -> its numbers."""
    import torch
    from dataclasses import replace

    from caesar_yolo_tpu_torch.cli import run as cli_run
    from caesar_yolo_tpu_torch.cli.preproc_args import (
        build_preprocessor_from_args,
    )
    from caesar_yolo_tpu_torch.parallel.sfinder import SFinder

    argv = [*flags, *MODES[mode]]
    t0 = time.perf_counter()
    if mode == "band":     # the CLI has no flag for the cap
        args = cli_run.parse_args(argv)
        sf = SFinder(cli_run.load_model_from_args(args), replace(
            cli_run.config_from_args(args),
            device_tiling_max_bytes=SIZE * TILE * 4),
            preprocessor=build_preprocessor_from_args(args))
        rc = sf.run_tiled()
    else:
        rc, sf = cli_run.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{mode} run failed")
    rep = sf.report
    return {"mode": mode, "path": getattr(rep, "tiling_mode", "stream"),
            "tiles_per_s": rep.n_tiles / wall, "wall_s": wall,
            "runtime_s": rep.runtime_s, "setup_s": wall - rep.runtime_s,
            "phase_times": rep.phase_times, "read_s": rep.read_s,
            "h2d_bytes": getattr(rep, "h2d_bytes", None)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose package runs")
    p.add_argument("--modes", default="auto,off,band,global")
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))
    import subprocess

    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    from caesar_yolo_tpu_torch.models.convert import save_params
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    from caesar_yolo_tpu_torch.utils.synth import write_mosaic_fits

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"{card}; package from {os.path.abspath(args.repo)}", flush=True)
    modes = args.modes.split(",")
    with tempfile.TemporaryDirectory(prefix="mosaic_modes_") as tmp:
        image = os.path.join(tmp, "mosaic.fits")
        write_mosaic_fits(image, nx=SIZE, ny=SIZE, n_sources=400, seed=0,
                          blank_border=16)
        weights = save_params(init_weights(build_model("yolo11l"), seed=0),
                              os.path.join(tmp, "yolo11l_seed0.npz"),
                              meta={"model": "yolo11l", "num_classes": 5})
        flags = [f"--image={image}", f"--weights={weights}",
                 "--scoreThr=1e-3", *CHAIN, *TILED,
                 f"--detect_outfile_json={os.path.join(tmp, 'c.json')}",
                 f"--detect_outfile={os.path.join(tmp, 'c.reg')}"]
        for mode in modes:      # warm-up: cuDNN's choices, kernel loads
            run_mode(mode, flags)
        results = {m: [] for m in modes}
        for r in range(args.rounds):
            order = modes if r % 2 == 0 else modes[::-1]
            for mode in order:
                row = run_mode(mode, flags)
                results[mode].append(row)
                print(json.dumps(row), flush=True)
    summary = {}
    for mode, rows in results.items():
        tps = np.asarray([r["tiles_per_s"] for r in rows])
        summary[mode] = {"tiles_per_s_median": float(np.median(tps)),
                         "tiles_per_s_quartiles": [
                             float(np.percentile(tps, 25)),
                             float(np.percentile(tps, 75))],
                         "n": len(rows),
                         "detect_s_median": float(np.median(
                             [r["phase_times"]["detect"] for r in rows])),
                         "setup_s_median": float(np.median(
                             [r["setup_s"] for r in rows]))}
    print(json.dumps({"card": card, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
