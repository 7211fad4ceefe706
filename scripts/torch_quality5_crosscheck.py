#!/usr/bin/env python3
"""Evaluate five-class weights on both packages' held-out streams, through
both packages' evaluations, on the CPU.

The two quality runs (scripts/train_quality5.py for the JAX package,
scripts/torch_train_quality5.py for the port) hold out 512 cutouts each,
drawn from seed 10_000_000 by their own random streams: jax.random keys
PRNGKey(10_000_000 + done) there, torch.Generator seeds 10_000_000 +
done here, batches of up to 64.  So their tables score the same recipe
on different cutouts.  This script takes weights in the JAX npz format
(`save_params` of either package) and scores them on each stream with
each evaluation, as both scripts' final evaluation does: a Predictor at
640 px (score 0.25, NMS IoU 0.5), merge_detections,
compute_metrics(iou_thr=0.6) and compute_map.  The npz is used as it is
(the quality scripts write it after precise-BN).

One JSON line per (npz, stream, evaluator): macro-F1, mAP50, mAP50-95
and each class's F1 and n_gt.  The (jax, jax) line is the JAX run's own
evaluation of these weights; (port, port) the port's; the crossed pairs
show whether the two evaluations agree on one stream.

Every evaluation is in f32, on the runs' 512 held-out cutouts, for all
four (stream, evaluator) pairs.

Usage: python3 scripts/torch_quality5_crosscheck.py W.npz [W2.npz ...]
(about 25 s a pair with JAX's evaluation, longer with the port's on a
few CPU threads.)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from torch_train_quality5 import (EVAL_IOU_MATCH, EVAL_SCORE_THR,  # noqa: E402
                                  HELDOUT_SEED0, MAX_SRC, NATIVE,
                                  class_table, eval_cutouts, macro_f1,
                                  score_batches)

IMGSZ = 640
NMS_IOU = 0.5
N_HELDOUT = 512      # the quality runs' held-out cutouts
PAIRS = (("jax", "jax"), ("jax", "port"), ("port", "port"), ("port", "jax"))


def jax_stream(n_imgs: int, seed0: int = HELDOUT_SEED0):
    """scripts/train_quality5.py's held-out batches as numpy."""
    import jax

    from caesar_yolo_tpu.utils.synth5 import make_multiclass_tile_fn
    make132 = make_multiclass_tile_fn(NATIVE, max_src=MAX_SRC)
    done = 0
    while done < n_imgs:
        b = min(64, n_imgs - done)
        out = make132(jax.random.PRNGKey(seed0 + done), b)
        yield tuple(np.array(v) for v in out)     # writable copies
        done += b


def port_stream(n_imgs: int, seed0: int = HELDOUT_SEED0):
    """scripts/torch_train_quality5.py's held-out batches as numpy."""
    return eval_cutouts(n_imgs, seed0, "cpu")


def jax_evaluate(path: str, batches):
    """scripts/train_quality5.py's evaluation of the npz's weights, in
    f32."""
    import jax.numpy as jnp

    from caesar_yolo_tpu.detect import Predictor, merge_detections
    from caesar_yolo_tpu.evaluation.metrics import (compute_map,
                                                    compute_metrics)
    from caesar_yolo_tpu.models.convert import load_params
    from caesar_yolo_tpu.models.yolo import build_model
    from caesar_yolo_tpu.utils.synth5 import CLASS_NAMES
    params, meta = load_params(path)
    model = build_model(meta["model"], num_classes=int(meta["num_classes"]))
    pred = Predictor(model, params, img_size=IMGSZ,
                     score_thr=EVAL_SCORE_THR, iou_thr=NMS_IOU,
                     compute_dtype=jnp.float32)
    gl, pl = [], []
    for imgs, labels, boxes, mask in batches:
        bb, ss, cc, vv, _ = (np.asarray(v) for v in
                             pred.predict_batch(imgs))
        for i in range(len(imgs)):
            sel = mask[i]
            gl.append({"bboxes": boxes[i][sel],
                       "labels": [CLASS_NAMES[int(k)]
                                  for k in labels[i][sel]]})
            v = vv[i]
            b, s, c = merge_detections(bb[i][v], ss[i][v], cc[i][v])
            pl.append({"bboxes": b, "scores": s,
                       "labels": [CLASS_NAMES[int(k)] for k in c]})
    return (compute_metrics(gl, pl, iou_thr=EVAL_IOU_MATCH),
            compute_map(gl, pl))


def port_evaluate(path: str, batches):
    """scripts/torch_train_quality5.py's evaluation of the npz's weights
    (its Predictor on the CPU, in f32)."""
    import torch

    from caesar_yolo_tpu_torch.detect.predictor import Predictor
    from caesar_yolo_tpu_torch.evaluation.metrics import compute_map
    from caesar_yolo_tpu_torch.models.convert import load_model
    model, _ = load_model(path)
    pred = Predictor(model, img_size=IMGSZ, score_thr=EVAL_SCORE_THR,
                     iou_thr=NMS_IOU, compute_dtype=torch.float32,
                     device="cpu")
    rep, gl, pl = score_batches(pred, batches)
    return rep, compute_map(gl, pl)


STREAMS = {"jax": jax_stream, "port": port_stream}
EVALUATORS = {"jax": jax_evaluate, "port": port_evaluate}


def crosscheck(path: str, pairs=PAIRS) -> list[dict]:
    """One record per (stream, evaluator) pair for the npz at `path`."""
    from caesar_yolo_tpu_torch.utils.synth5 import CLASS_NAMES
    out = []
    for stream, evaluator in pairs:
        t0 = time.time()
        rep, mrep = EVALUATORS[evaluator](path, STREAMS[stream](N_HELDOUT))
        table = class_table(rep, CLASS_NAMES)
        out.append({
            "npz": os.path.relpath(path, ROOT) if path.startswith(ROOT)
            else path,
            "stream": stream, "evaluator": evaluator, "dtype": "float32",
            "n_images": N_HELDOUT,
            "macro_f1": round(macro_f1(table, CLASS_NAMES), 4),
            "map50": round(float(mrep.map50), 4),
            "map50_95": round(float(mrep.map50_95), 4),
            "per_class": {k: {"F1": table[k]["F1"],
                              "n_gt": table[k]["n_gt"]}
                          for k in CLASS_NAMES},
            "seconds": round(time.time() - t0, 1)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("npz", nargs="+")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    for path in args.npz:
        for rec in crosscheck(os.path.abspath(path)):
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
