#!/usr/bin/env python3
"""Five-class quality run of the PyTorch port: train yolov8n from scratch
on the synthetic five-morphology task on one CUDA card and publish the
per-class C/R/F1 table.

The twin of scripts/train_quality5.py (the JAX package's run), with the
same recipe:
  yolov8n, 5 classes, weights seeded `--seed`; TrainConfig(epochs=1, batch 16,
  lr0 0.01, lrf 0.05, warmup 0.02 epochs, max_gt 4), one epoch of `steps`
  steps; each step renders 16 cutouts of 132 px (utils/synth5.py),
  resizes them bilinearly to imgsz (jax.image.resize's linear weights,
  ops/transforms._resize_weights), scales the boxes by imgsz / 132,
  augments them (rot 180 / flip 0.5 / scale 0.89) and takes one bf16
  training step.
Validation every `val_every` steps on 128 cutouts of stream 20_000_000:
precise-BN over 8 calibration batches, the EMA weights in a bf16
Predictor at imgsz (score 0.25, IoU 0.5), merge_detections,
compute_metrics(iou_thr=0.6); the best macro-F1 is kept.  The final
held-out evaluation runs the best weights on 512 cutouts of stream
10_000_000 (QUALITY5_NEVAL overrides the count) and adds compute_map.

Random streams: each training step's cutouts and augmentation come from
one torch.Generator seeded 30_000_000 + 1_000_000 * seed + step,
calibration batch i from seed 4242 + i, and an evaluation batch of up to
64 cutouts from seed stream + (cutouts done before it); the JAX run draws
from jax.random keys, so the two runs see different cutouts
(scripts/torch_quality5_crosscheck.py evaluates one npz on both held-out
streams).  `--seed k` moves the weights' init seed (k) and the training
stream; validation, calibration and the held-out set stay the same for
every seed, and seed 0 is the run above.  `--compute_dtype float32`
trains in f32 with TF32 off on the card (a control; validation stays a
bf16 Predictor).

Writes `out` (default QUALITY_torch_h100.json, or
QUALITY_torch_h100_seed<k>.json for seed k > 0, with `_f32` before
`.json` for an f32 run) and its `_trajectory.jsonl`, and the final EMA
weights (the best step's, BN recalibrated) as an npz in the JAX format
beside `out` (`<out stem>_v8n.npz`).  The gate is the JAX run's:
macro-F1 > 0.5 and every class's F1 > 0.2 (exit 0), else exit 1.

Usage: python3 scripts/torch_train_quality5.py [steps=12000] [imgsz=640]
           [val_every=1000] [out] [ckpt_dir] [--seed k]
           [--compute_dtype bfloat16|float32]
       (QUALITY5_DEVICE=cpu runs on the CPU, for a rehearsal at a tiny
       size)
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCH = 16
MAX_SRC = 4
NATIVE = 132
EVAL_SCORE_THR = 0.25
EVAL_IOU_MATCH = 0.6  # reference make_prediction.py iou_thr
TRAIN_SEED0 = 30_000_000
SEED_STRIDE = 1_000_000     # one seed's training stream: steps < 1e6
CAL_SEED0 = 4242
VAL_SEED0 = 20_000_000
N_VAL = 128
HELDOUT_SEED0 = 10_000_000


def card_name(device) -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    if smi.returncode != 0 or not lines:
        raise RuntimeError("nvidia-smi failed")
    return lines[0]


def resize_bilinear(imgs, size: int):
    """[B, H, W, C] -> [B, size, size, C] contiguous (K8's row route takes
    no other layout), by jax.image.resize's linear weights along each
    axis."""
    import torch
    from caesar_yolo_tpu_torch.ops.transforms import _resize_weights
    _, h, w, _ = imgs.shape
    out = torch.einsum("bhwc,hi->biwc", imgs,
                       _resize_weights(h, size, imgs.device))
    return torch.einsum("bhwc,wj->bhjc", out,
                        _resize_weights(w, size, imgs.device)).contiguous()


def class_table(rep, class_names):
    table = {}
    for name in class_names:
        c = rep.completeness.get(name)
        r = rep.reliability.get(name)
        f = rep.f1.get(name)
        table[name] = {
            "C": round(c.ratio, 4) if c and c.n else None,
            "R": round(r.ratio, 4) if r and r.n else None,
            "F1": round(f, 4) if f is not None and np.isfinite(f) else None,
            "n_gt": c.n if c else 0,
        }
    src = rep.completeness.get("source")
    f_src = rep.f1.get("source", float("nan"))
    table["source_cumulative"] = {
        "C": round(src.ratio, 4) if src and src.n else None,
        "R": round(rep.reliability["source"].ratio, 4)
        if rep.reliability.get("source") else None,
        "F1": round(f_src, 4) if np.isfinite(f_src) else None,
        "n_gt": src.n if src else 0,
    }
    return table


def macro_f1(table, class_names) -> float:
    vals = [v["F1"] for k, v in table.items()
            if k in class_names and v["F1"] is not None]
    return float(np.mean(vals)) if vals else 0.0


def passes_gate(table, class_names) -> bool:
    return (macro_f1(table, class_names) > 0.5
            and all(table[n]["F1"] is not None and table[n]["F1"] > 0.2
                    for n in class_names))


def eval_cutouts(n_imgs: int, seed0: int, device):
    """Batches (imgs, labels, boxes, mask) as numpy, of up to 64 cutouts,
    batch k from seed seed0 + (cutouts before it)."""
    from caesar_yolo_tpu_torch.utils.synth5 import make_multiclass_batch
    done = 0
    while done < n_imgs:
        b = min(64, n_imgs - done)
        out = make_multiclass_batch(seed0 + done, b, max_src=MAX_SRC,
                                    device=device)
        yield tuple(t.cpu().numpy() for t in out)
        done += b


def evaluate_predictor(pred, n_imgs: int, seed0: int, device):
    """The JAX script's evaluation on a Predictor -> (report, gt list,
    prediction list)."""
    return score_batches(pred, eval_cutouts(n_imgs, seed0, device))


def score_batches(pred, batches):
    """The JAX script's evaluation of a Predictor on numpy batches (imgs,
    labels, boxes, mask) -> (report, gt list, prediction list)."""
    from caesar_yolo_tpu_torch.detect.merge import merge_detections
    from caesar_yolo_tpu_torch.evaluation.metrics import compute_metrics
    from caesar_yolo_tpu_torch.utils.synth5 import CLASS_NAMES
    gl, pl = [], []
    for imgs, labels, boxes, mask in batches:
        bb, ss, cc, vv, _ = (t.cpu().numpy()
                             for t in pred.predict_batch(imgs))
        for i in range(len(imgs)):
            sel = mask[i]
            gl.append({"bboxes": boxes[i][sel],
                       "labels": [CLASS_NAMES[int(k)]
                                  for k in labels[i][sel]]})
            v = vv[i]
            b, s, c = merge_detections(bb[i][v], ss[i][v], cc[i][v])
            pl.append({"bboxes": b, "scores": s,
                       "labels": [CLASS_NAMES[int(k)] for k in c]})
    return compute_metrics(gl, pl, iou_thr=EVAL_IOU_MATCH), gl, pl


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=12000)
    ap.add_argument("imgsz", nargs="?", type=int, default=640)
    ap.add_argument("val_every", nargs="?", type=int, default=1000)
    ap.add_argument("out", nargs="?", default=None)
    ap.add_argument("ckpt_dir", nargs="?", default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="init seed of the weights and the training "
                         "stream's offset (0: the published run)")
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    if args.seed < 0 or args.steps >= SEED_STRIDE:
        ap.error("--seed is >= 0 and steps stay below 1e6 (the training "
                 "streams of two seeds must not meet)")
    return args


def default_out(seed: int, compute_dtype: str) -> str:
    """QUALITY_torch_h100.json for the published run (seed 0, bf16), else
    QUALITY_torch_h100[_seed<k>][_f32].json."""
    return ("QUALITY_torch_h100" + (f"_seed{seed}" if seed else "")
            + ("_f32" if compute_dtype == "float32" else "") + ".json")


def main() -> int:
    import torch
    from caesar_yolo_tpu_torch.detect.predictor import Predictor
    from caesar_yolo_tpu_torch.evaluation.metrics import compute_map
    from caesar_yolo_tpu_torch.models.convert import save_params
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    from caesar_yolo_tpu_torch.train.augment import (augment_batch,
                                                     draw_augment_params)
    from caesar_yolo_tpu_torch.train.trainer import TrainConfig, Trainer
    from caesar_yolo_tpu_torch.utils.device import resolve_device
    from caesar_yolo_tpu_torch.utils.synth5 import (CLASS_NAMES,
                                                    draw_multiclass_params,
                                                    make_multiclass_batch,
                                                    render_multiclass)

    args = parse_args()
    steps, imgsz, val_every = args.steps, args.imgsz, args.val_every
    out_path = args.out or default_out(args.seed, args.compute_dtype)
    ckpt_dir = args.ckpt_dir or os.path.abspath("train_quality5_ckpt")
    train_seed0 = TRAIN_SEED0 + SEED_STRIDE * args.seed
    n_eval = int(os.environ.get("QUALITY5_NEVAL", "512"))
    stem = os.path.splitext(out_path)[0]
    traj_path = stem + "_trajectory.jsonl"
    npz_path = stem + "_v8n.npz"
    device = resolve_device(os.environ.get("QUALITY5_DEVICE"))
    card = card_name(device)
    print(card, flush=True)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    if args.compute_dtype == "float32":     # the f32 control: no TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    cfg = TrainConfig(epochs=1, batch_size=BATCH, img_size=imgsz,
                      lr0=0.01, lrf=0.05, warmup_epochs=0.02,
                      max_gt=MAX_SRC, compute_dtype=args.compute_dtype)
    scale = imgsz / float(NATIVE)

    def train_inputs(step):
        """132 px synth -> resize to imgsz -> the reference augmentation."""
        gen = torch.Generator().manual_seed(train_seed0 + step)
        draws = draw_multiclass_params(gen, BATCH, max_src=MAX_SRC)
        aug = draw_augment_params(gen, BATCH)
        draws = {k: v.to(device) for k, v in draws.items()}
        imgs, labels, boxes, mask = render_multiclass(draws, max_src=MAX_SRC)
        imgs = resize_bilinear(imgs, imgsz)
        ai, ab, am = augment_batch(imgs, boxes * scale, mask, *aug)
        return ai, labels, ab, am

    def cal_inputs(i):
        imgs = make_multiclass_batch(CAL_SEED0 + i, BATCH, max_src=MAX_SRC,
                                     device=device)[0]
        return resize_bilinear(imgs, imgsz)

    def evaluate(n_imgs, seed0):
        trainer.calibrate_bn([cal_inputs(i) for i in range(8)])
        pred = Predictor(trainer.ema_model(), img_size=imgsz,
                         score_thr=EVAL_SCORE_THR, iou_thr=0.5,
                         compute_dtype=torch.bfloat16, device=device)
        return evaluate_predictor(pred, n_imgs, seed0, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    trainer = Trainer(init_weights(build_model("yolov8n", num_classes=5),
                                   seed=args.seed), cfg,
                      steps_per_epoch=steps, device=device)

    best_f1, best_step = -1.0, -1
    val_s = 0.0
    t0 = time.time()
    with open(traj_path, "a") as traj:
        for step in range(steps):
            loss, parts = trainer.train_step(*train_inputs(step))
            if step % 250 == 0 or step == steps - 1:
                print(f"step {step}: loss={float(loss):.3f} "
                      f"box={float(parts['box']):.3f} "
                      f"cls={float(parts['cls']):.3f} "
                      f"dfl={float(parts['dfl']):.3f} "
                      f"({BATCH * (step + 1) / (time.time() - t0):.1f} "
                      f"imgs/s)", flush=True)
            if (step + 1) % val_every == 0 or step + 1 == steps:
                sync()
                tv = time.time()
                rep, _, _ = evaluate(N_VAL, VAL_SEED0)
                table = class_table(rep, CLASS_NAMES)
                mf1 = macro_f1(table, CLASS_NAMES)
                sync()
                val_s += time.time() - tv
                elapsed = time.time() - t0
                rec = {"step": step + 1, "loss": float(loss),
                       "macro_f1": round(mf1, 4), "classes": table,
                       "imgs_per_s": round(BATCH * (step + 1) / elapsed, 1),
                       "train_imgs_per_s": round(
                           BATCH * (step + 1) / (elapsed - val_s), 1),
                       "val_s": round(val_s, 1)}
                traj.write(json.dumps(rec) + "\n")
                traj.flush()
                print("VAL", json.dumps(rec), flush=True)
                if mf1 > best_f1:
                    best_f1, best_step = mf1, step + 1
                    trainer.best_metric = mf1
                    trainer.save_checkpoint(ckpt_dir, step=step + 1,
                                            name="best")
    sync()
    train_time = time.time() - t0
    trainer.save_checkpoint(ckpt_dir, step=steps, name="last")

    # the gated best for the final held-out evaluation (the best.pt
    # convention, reference macros/run_train.py)
    if 0 < best_step != steps:
        trainer.restore(os.path.join(ckpt_dir, "best"))
    rep, gl, pl = evaluate(n_eval, HELDOUT_SEED0)
    table = class_table(rep, CLASS_NAMES)
    mrep = compute_map(gl, pl)
    mf1 = macro_f1(table, CLASS_NAMES)
    result = {
        "task": "synthetic 5-class radio morphologies "
                "(caesar_yolo_tpu_torch/utils/synth5.py; offline analog of "
                "the Riggi+2023 dataset, reference README.md:190-207)",
        "model": "yolov8n", "imgsz": imgsz, "native_cutout": NATIVE,
        "steps": steps, "batch": BATCH, "seed": args.seed,
        "compute_dtype": args.compute_dtype,
        "recipe": "rot180/flip0.5/scale0.89 device augmentation, "
                  + ("bf16" if args.compute_dtype == "bfloat16"
                     else "f32 (no TF32)")
                  + " step, SGD momentum warmup-cosine, EMA, precise-BN",
        "score_thr": EVAL_SCORE_THR, "iou_match": EVAL_IOU_MATCH,
        "n_eval_images": n_eval,
        "per_class": table,
        "macro_f1": round(mf1, 4),
        "map50": round(float(mrep.map50), 4),
        "map50_95": round(float(mrep.map50_95), 4),
        "best_val_step": best_step,
        "train_time_s": round(train_time, 1),
        "train_imgs_per_s": round(BATCH * steps / train_time, 1),
        "train_step_imgs_per_s": round(
            BATCH * steps / (train_time - val_s), 1),
        "device": card,
    }
    with open(out_path, "w") as fh:
        json.dump(result, fh, indent=1)
    save_params(trainer.ema_model(), npz_path, meta={
        "model": "yolov8n", "num_classes": 5, "steps": steps,
        "seed": args.seed, "best_val_step": best_step,
        "macro_f1": result["macro_f1"],
        "map50": result["map50"], "device": card})
    print("QUALITY", json.dumps(result), flush=True)
    ok = passes_gate(table, CLASS_NAMES)
    print(f"RESULT macro_f1={mf1:.3f} best@{best_step} "
          f"{'PASS' if ok else 'BELOW-GATE'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
