#!/usr/bin/env python3
"""How far f32 rounding alone moves chip_smoke.py's yolo11l training steps.

The multiproc phase of chip_smoke.py holds two gloo ranks (8 images each)
to one process on the global batch of 16 (yolo11l at 640 px, seeded
weights, f32 with TF32 off, augmented once, 2 steps).  This script runs
that one process twice more, once on the same batch with its rows rolled
by 8 (the same arithmetic in another order), and compares each run with
the one process: the golden-train rule as it stands
(tests/test_torch_train_golden.golden_mismatch), how many update norms
miss its 1e-3, and the rule with each tensor's f32 resolution
(chip_smoke.train_mismatch).  Each run is a subprocess of
tests/torch_mp_worker.py.  Prints the card's name and power limit and one
JSON line.

Run from the repository root on a CUDA card:
    python3 scripts/torch_mp_train_noise.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import chip_smoke as cs
    import test_torch_train_golden as golden_train

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    spec = dict(mode="train", model="yolo11l", seed=0,
                batch=[cs.MP_TRAIN_BATCH, cs.MAIN_SIZE],
                augment=cs.MP_AUGMENT_SEED, steps=cs.MP_TRAIN_STEPS,
                summary_after=cs.MP_TRAIN_STEPS, compute_dtype="float32")
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, world, extra, init in (
                ("one", 1, {}, None),
                ("one_rolled", 1, {"roll": cs.MP_TRAIN_BATCH // 2}, None),
                ("two_ranks", 2, {"backend": "gloo", "device": "cuda:0"},
                 "env")):
            ranks, _ = cs.launch_ranks(tmp, key, dict(spec, **extra), world,
                                       init)
            runs[key] = cs.summary_arrays(ranks[0]["summary"])
    ref = runs["one"]
    out = {"card": card}
    for key in ("one_rolled", "two_ranks"):
        got = runs[key]
        err = np.abs(got["update_norms"] - ref["update_norms"])
        rel = err / np.maximum(ref["update_norms"], 1e-30)
        past = err > golden_train.UPDATE_RTOL * ref["update_norms"] + 1e-9
        out[key] = {
            "loss_rel": float((np.abs(got["loss"] - ref["loss"])
                               / ref["loss"]).max()),
            "rule": golden_train.golden_mismatch(ref, got),
            "past_rule": int(past.sum()), "tensors": int(len(err)),
            "max_rel_past_rule": float(rel[past].max()) if past.any() else 0,
            "rule_with_resolution": cs.train_mismatch(golden_train, ref, got)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
