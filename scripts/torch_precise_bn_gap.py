#!/usr/bin/env python3
"""Precise-BN's statistics from an f32 and from a bf16 train-mode forward
of the same weights, on the five-class quality run's calibration batches,
on the CPU.

`Trainer.calibrate_bn` forwards in f32 under every compute dtype, as the
reference's does (its model computes in the dtype of its f32 images).
Before, the port forwarded in the config's compute dtype (bf16 by
default).  This script measures what that changes: for each BatchNorm's
averaged mean and variance, the largest gap between the two forwards
relative to the tensor's largest value.  With --heldout it also scores
both recalibrated models on JAX's held-out stream through JAX's
evaluation in f32 (scripts/torch_quality5_crosscheck.py).

Prints one JSON line.

Usage: python3 scripts/torch_precise_bn_gap.py [W.npz]
           [--imgsz 640] [--heldout]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from torch_train_quality5 import (BATCH, CAL_SEED0, MAX_SRC,  # noqa: E402
                                  resize_bilinear)

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_quality5_v8n.npz")


def bf16_forward_stats(model, batches) -> dict:
    """{state key: statistic} averaged in f64 over `batches`, each taken
    from a train-mode forward in bf16.  A frozen record of the port's
    precise-BN before its forward became f32: it is kept as that was, not
    in step with `Trainer.calibrate_bn`."""
    import torch

    from caesar_yolo_tpu_torch.models.layers import BatchNorm, train_mode
    names = {m: n for n, m in model.named_modules()
             if isinstance(m, BatchNorm)}
    sums: dict = {}
    with torch.no_grad():
        for images in batches:
            stats: dict = {}
            with train_mode(model, stats):
                model(images.permute(0, 3, 1, 2).to(torch.bfloat16))
            for bn, pair in stats.items():
                for which, t in zip(("mean", "var"), pair):
                    key = f"{names[bn]}.{which}"
                    sums[key] = sums.get(key, 0.0) + t.double().numpy()
    return {k: (v / len(batches)).astype(np.float32)
            for k, v in sums.items()}


def main(argv=None) -> int:
    import torch

    from caesar_yolo_tpu_torch.models.convert import load_model, save_params
    from caesar_yolo_tpu_torch.train.trainer import TrainConfig, Trainer
    from caesar_yolo_tpu_torch.utils.synth5 import make_multiclass_batch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("npz", nargs="?", default=FIXTURE)
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--heldout", action="store_true",
                    help="score both recalibrated models on JAX's "
                         "held-out stream (JAX's evaluation, f32)")
    args = ap.parse_args(argv)

    model, meta = load_model(args.npz)
    batches = [resize_bilinear(make_multiclass_batch(
        CAL_SEED0 + i, BATCH, max_src=MAX_SRC, device="cpu")[0], args.imgsz)
        for i in range(8)]
    trainer = Trainer(copy.deepcopy(model),
                      TrainConfig(img_size=args.imgsz, batch_size=BATCH,
                                  compute_dtype="bfloat16"), device="cpu")
    trainer.calibrate_bn(batches)
    f32 = {k: v.numpy() for k, v in trainer.model.state_dict().items()
           if k.endswith((".bn.mean", ".bn.var"))}
    bf16 = bf16_forward_stats(copy.deepcopy(model), batches)
    gaps = {k: float(np.abs(bf16[k] - r).max() / np.abs(r).max())
            for k, r in f32.items()}
    layers = sorted({k.rsplit(".", 1)[0] for k in gaps})
    per_layer = [max(gaps[f"{n}.mean"], gaps[f"{n}.var"]) for n in layers]
    worst = max(gaps, key=gaps.get)
    out = {"npz": os.path.relpath(os.path.abspath(args.npz), ROOT),
           "imgsz": args.imgsz, "batches": len(batches),
           "layers": len(layers), "max_gap": round(gaps[worst], 6),
           "max_gap_at": worst,
           "median_layer_gap": round(float(np.median(per_layer)), 6)}
    if args.heldout:
        import jax
        jax.config.update("jax_platforms", "cpu")
        from torch_quality5_crosscheck import crosscheck
        with tempfile.TemporaryDirectory() as tmp:
            for name, stats in (("f32_forward", f32), ("bf16_forward", bf16)):
                m = copy.deepcopy(model)
                m.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in stats.items()}, strict=False)
                path = os.path.join(tmp, f"{name}.npz")
                save_params(m, path, meta=meta)
                rec = crosscheck(path, [("jax", "jax")])[0]
                out[f"heldout_macro_f1_{name}"] = rec["macro_f1"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
