"""Training entry point.

Counterpart of caesar_yolo_tpu/cli/train.py with its flags and defaults
(the reference's run_train macro: the published SGD recipe and the
augmentation config degrees=180, flips 0.5, scale 0.89), on one GPU or
data-parallel on several, one process each:

    python -m caesar_yolo_tpu_torch.cli.train --data=dataset.yaml \\
        --model=yolo11l --epochs=300 --batch=16 --imgsz=640
    torchrun --nproc_per_node=4 -m caesar_yolo_tpu_torch.cli.train ...

Runs on CUDA (under torchrun, cuda:{LOCAL_RANK}); `--devices` names the
device instead (`cpu` for the CPU, where the ranks talk over gloo).  Under
a launcher --batch is the global batch, rounded up to a multiple of the
processes; every rank reads every global batch and takes its rows
[r*B/n, (r+1)*B/n), with the same rows of the batch's augmentation draws,
so the run is the one-process run's over the same global batch (the JAX
CLI feeds each process the whole batch instead, its cli/train.py:
176-179).  Precise-BN runs on every rank over global statistics;
validation runs on rank 0, which writes every file.  Batches ship at native
resolution and are letterboxed on the device; augmentation draws and the
sample order are keyed by (seed, epoch), so `--resume` replays what an
uninterrupted run drew.  With a validation source (--val_data: a
directory or a filelist; else a `val:` split of the dataset YAML) the EMA
weights are scored every --val_every epochs, after a precise-BN pass over
8 batches of the dataset, through a BatchedDetector and evaluate_dataset;
the best epoch by --gate_metric (source F1, or the fitness
0.1*mAP50 + 0.9*mAP50-95) is checkpointed as `best`, its metric kept
across --resume.  At the end: precise-BN over an augmented epoch, the
final validation on those statistics, the `last` checkpoint, and the EMA
weights exported as `last.npz` in the reference's npz format
(models/convert.save_params).
"""

from __future__ import annotations

import argparse
import itertools
import os
import re
import sys

from caesar_yolo_tpu_torch import logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="caesar-yolo-tpu training (PyTorch port)")
    p.add_argument("--data", required=True,
                   help="dataset.yaml or train image directory")
    p.add_argument("--model", default="yolov8l")
    p.add_argument("--num_classes", type=int, default=5)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--lr0", type=float, default=0.01)
    p.add_argument("--lrf", type=float, default=0.01)
    p.add_argument("--weights", default="",
                   help="initial weights (.npz) for fine-tuning")
    p.add_argument("--resume", default="",
                   help="resume an interrupted run from a checkpoint written "
                        "by this trainer (weights, EMA, momentum and the "
                        "schedule position).  Pass a step_N/last path or the "
                        "--checkpoint_dir to pick the latest")
    p.add_argument("--checkpoint_dir", default="runs/train")
    p.add_argument("--checkpoint_every", type=int, default=10)
    p.add_argument("--max_gt", type=int, default=64)
    p.add_argument("--degrees", type=float, default=180.0)
    p.add_argument("--scale", type=float, default=0.89)
    p.add_argument("--flipud", type=float, default=0.5)
    p.add_argument("--fliplr", type=float, default=0.5)
    p.add_argument("--no_augment", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="recompute layer activations in backward")
    p.add_argument("--fp32", action="store_true",
                   help="train in float32 (default: bf16 compute with f32 "
                        "master weights)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--val_data", default="",
                   help="val images: a directory, a filelist txt, or "
                        "empty to use the dataset.yaml 'val' split")
    p.add_argument("--val_every", type=int, default=10,
                   help="validate every N epochs (0 = only at the end)")
    p.add_argument("--val_score_thr", type=float, default=0.25)
    p.add_argument("--val_iou_match", type=float, default=0.6)
    p.add_argument("--val_max_images", type=int, default=200)
    p.add_argument("--gate_metric", choices=["f1", "fitness"], default="f1",
                   help="best-checkpoint criterion: source F1 or "
                        "0.1*mAP50 + 0.9*mAP50-95")
    p.add_argument("--devices", type=str, default="",
                   help="torch device (default cuda, under torchrun "
                        "cuda:LOCAL_RANK; cpu runs on the CPU)")
    return p.parse_args(argv)


def resolve_resume_checkpoint(path: str) -> str:
    """--resume -> a checkpoint file: the path itself when it is one, else
    the step_N or `last` in that directory holding the HIGHEST optimizer
    step by its `.step` sidecar ('last' wins ties; never 'best')."""

    def ckpt_step(p):
        try:
            with open(p + ".step") as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return 0

    if os.path.isfile(path):
        return path
    candidates = []  # (step, tiebreak, path)
    if os.path.isdir(path):
        last = os.path.join(path, "last")
        if os.path.isfile(last):
            candidates.append((ckpt_step(last), 1, last))
        for name in os.listdir(path):
            m = re.fullmatch(r"step_(\d+)", name)
            p = os.path.join(path, name)
            if m and os.path.isfile(p):
                candidates.append((ckpt_step(p) or int(m.group(1)), 0, p))
    if candidates:
        return max(candidates)[2]
    raise FileNotFoundError(
        f"--resume={path}: no checkpoint found (expected a checkpoint file "
        f"or a directory containing last/step_N)")


def list_val_images(args) -> list[str] | None:
    """The validation images from --val_data (a directory or a filelist)
    or the dataset YAML's `val` split; None when there is no source."""
    from caesar_yolo_tpu_torch.evaluation.evaluate import read_filelist
    from caesar_yolo_tpu_torch.train.dataset import (
        list_images,
        parse_dataset_yaml,
    )
    if args.val_data:
        if os.path.isdir(args.val_data):
            return list_images(args.val_data) or None
        return read_filelist(args.val_data) or None
    if args.data.endswith((".yaml", ".yml")):
        spec = parse_dataset_yaml(args.data)
        if "val" in spec:
            root = spec.get("path", os.path.dirname(args.data))
            rel = spec["val"]
            d = rel if os.path.isabs(rel) else os.path.join(root, rel)
            if os.path.isdir(d):
                return list_images(d) or None
    return None


def epoch_generator(seed: int, epoch: int):
    """The augmentation stream of one epoch: a torch.Generator seeded by
    (seed, epoch) alone."""
    import numpy as np
    import torch
    state = np.random.SeedSequence([seed, epoch]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def run(argv=None):
    """Parse and train -> (exit code, the Trainer after its run)."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from caesar_yolo_tpu_torch.detect.letterbox import letterbox_batch
    from caesar_yolo_tpu_torch.models.convert import (
        load_jax_params,
        load_params,
        save_params,
    )
    from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
    from caesar_yolo_tpu_torch.train.augment import (
        augment_batch,
        draw_augment_params,
    )
    from caesar_yolo_tpu_torch.parallel import mesh
    from caesar_yolo_tpu_torch.train.dataset import DetectionDataset
    from caesar_yolo_tpu_torch.train.trainer import TrainConfig, Trainer
    from caesar_yolo_tpu_torch.utils.device import resolve_device

    mesh.initialize_distributed(device=args.devices or None)
    device = resolve_device(args.devices or None)
    nproc, rank = mesh.process_count(), mesh.process_index()
    master = rank == 0
    batch = mesh.pad_to_multiple(max(args.batch, nproc), nproc)
    if batch != args.batch:
        logger.info("Global batch %d rounded up to %d for %d processes",
                    args.batch, batch, nproc)
    rows = slice(rank * batch // nproc, (rank + 1) * batch // nproc)
    model = build_model(args.model, num_classes=args.num_classes)
    if args.weights:
        load_jax_params(model, load_params(args.weights)[0])
        logger.info("Fine-tuning from %s", args.weights)
    else:
        init_weights(model, seed=args.seed)

    dataset = DetectionDataset(args.data, img_size=args.imgsz,
                               batch_size=batch, max_gt=args.max_gt,
                               seed=args.seed, device_letterbox=True)
    steps = max(len(dataset), 1)
    cfg = TrainConfig(epochs=args.epochs, batch_size=batch,
                      img_size=args.imgsz, lr0=args.lr0, lrf=args.lrf,
                      max_gt=args.max_gt, remat=args.remat,
                      compute_dtype="float32" if args.fp32 else "bfloat16")
    trainer = Trainer(model, cfg, steps_per_epoch=steps, device=device)
    logger.info("Training %s on %s (rank %d of %d), %d batches/epoch",
                args.model, device, rank, nproc, len(dataset))

    start_epoch = 0
    if args.resume:
        step = trainer.restore(resolve_resume_checkpoint(args.resume))
        start_epoch = min(step // steps, args.epochs)
        logger.info("Resuming at epoch %d/%d (step %d)", start_epoch,
                    args.epochs, step)

    def prep_pixels(imgs):
        """Device-side 1->3 channel repeat and letterbox to imgsz (the
        geometry the loader's box math used)."""
        t = torch.from_numpy(imgs).to(device, torch.float32)
        if t.shape[-1] == 1:
            t = t.repeat(1, 1, 1, 3)
        if t.shape[1] != args.imgsz or t.shape[2] != args.imgsz:
            t = letterbox_batch(t, args.imgsz)
        return t

    def augmented(epoch):
        """This rank's rows of each global batch, augmented by the rows'
        draws from the global batch's."""
        dataset.set_epoch(epoch)
        gen = epoch_generator(args.seed, epoch)
        for imgs, labels, boxes, masks in dataset:
            n = imgs.shape[0]
            imgs, labels, boxes, masks = (a[rows] for a in
                                          (imgs, labels, boxes, masks))
            imgs = prep_pixels(imgs)
            if args.no_augment:
                yield imgs, labels, boxes, masks
                continue
            draws = draw_augment_params(
                gen, n, degrees=args.degrees, scale=args.scale,
                flipud=args.flipud, fliplr=args.fliplr)
            aimgs, aboxes, amasks = augment_batch(
                imgs, torch.from_numpy(boxes), torch.from_numpy(masks),
                *(d[rows] for d in draws))
            yield aimgs, labels, aboxes, amasks

    # validation: C/R/F1 and mAP of the EMA weights on the val images, on
    # rank 0; the best epoch is checkpointed as "best" (the reference's
    # best.pt)
    val_paths = list_val_images(args)
    val_detector = None
    if val_paths and master:
        from caesar_yolo_tpu_torch.detect.batch import BatchedDetector
        val_detector = BatchedDetector(
            model, img_size=args.imgsz, score_thr=args.val_score_thr,
            batch_size=min(args.batch, 32), device=device)
        logger.info("Validating on %d images every %d epoch(s)",
                    len(val_paths), max(args.val_every, 1))

    def run_validation(epoch, calibrate=True):
        if calibrate:
            # precise-BN on 8 batches of the dataset, not of the augmented
            # stream (every rank: its statistics are the global batch's)
            trainer.calibrate_bn(prep_pixels(imgs[rows]) for imgs, *_ in
                                 itertools.islice(iter(dataset), 8))
        metric = evaluate(epoch) if master else 0.0
        if nproc > 1:
            metric = float(mesh.broadcast_(torch.tensor(
                [metric], dtype=torch.float64, device=device))[0])
        if metric > trainer.best_metric:
            trainer.best_metric = metric  # kept in every checkpoint
            trainer.save_checkpoint(args.checkpoint_dir, step=epoch,
                                    name="best")
        return metric

    def evaluate(epoch):
        """The EMA weights' validation metric (rank 0)."""
        from caesar_yolo_tpu_torch.evaluation import evaluate_dataset
        from caesar_yolo_tpu_torch.outputs.catalog import CLASS_NAMES
        val_detector.engine.update_params(trainer.ema_model())
        report = evaluate_dataset(
            None, val_paths, detector=val_detector,
            score_thr=args.val_score_thr, iou_thr=args.val_iou_match,
            max_images=args.val_max_images,
            class_names=dataset.class_names or CLASS_NAMES)
        f1 = report.f1.get("source", 0.0)
        if f1 is None or not np.isfinite(f1):
            f1 = 0.0  # no predictions yet: F1 is 0
        fitness = 0.0
        if report.map is not None and np.isfinite(report.map.map50):
            # ultralytics' best.pt criterion (DetMetrics.fitness)
            fitness = 0.1 * report.map.map50 + 0.9 * report.map.map50_95
        logger.info("epoch %d val F1(source)=%.4f fitness=%.4f\n%s",
                    epoch, f1, fitness, report.summary())
        return fitness if args.gate_metric == "fitness" else f1

    for epoch in range(start_epoch, args.epochs):
        trainer.fit(augmented(epoch), epochs=1, checkpoint_dir=None)
        if args.checkpoint_dir and args.checkpoint_every \
                and (epoch + 1) % args.checkpoint_every == 0:
            trainer.save_checkpoint(args.checkpoint_dir, step=epoch + 1)
        if (val_paths and args.val_every
                and (epoch + 1) % args.val_every == 0
                and epoch + 1 < args.epochs):
            run_validation(epoch + 1)
    # precise-BN over a full augmented epoch; the final validation uses
    # those statistics (an 8-batch pass would overwrite them), then 'last'
    trainer.calibrate_bn(imgs for imgs, *_ in augmented(args.epochs))
    if val_paths:
        run_validation(args.epochs, calibrate=False)
    trainer.save_checkpoint(args.checkpoint_dir, step=args.epochs,
                            name="last")
    if master:
        out = save_params(trainer.ema_model(),
                          os.path.join(args.checkpoint_dir, "last.npz"),
                          meta={"model": args.model,
                                "num_classes": args.num_classes})
        logger.info("Exported the EMA weights to %s", out)
    return 0, trainer


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
