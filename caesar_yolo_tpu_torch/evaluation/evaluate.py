"""Dataset evaluation: predict over a labelled filelist and compute
completeness / reliability / F1 and mAP.

Counterpart of caesar_yolo_tpu/evaluation/evaluate.py (the reference's
evaluation macro, macros/make_prediction.py:553-694): read an image
filelist and YOLO-format labels, run the same predict + merge pipeline as
detection through the shape-bucketed BatchedDetector, then score with the
IoU >= 0.6 matching rules and the COCO-style AP sweep.  The model carries
its weights (no `params` argument, unlike the reference package).
"""

from __future__ import annotations

import json
import os

import numpy as np

from caesar_yolo_tpu_torch import logger
from caesar_yolo_tpu_torch.detect.batch import BatchedDetector
from caesar_yolo_tpu_torch.detect.merge import merge_detections
from caesar_yolo_tpu_torch.evaluation.metrics import (
    MetricsReport,
    compute_map,
    compute_metrics,
    per_image_match_detail,
    read_yolo_labels,
)
from caesar_yolo_tpu_torch.outputs.catalog import CLASS_NAMES
from caesar_yolo_tpu_torch.utils.fits import read_fits, read_image
from caesar_yolo_tpu_torch.utils.misc import read_filelist


def load_eval_image(img_path: str):
    """[H, W] or [H, W, C] float32 in [0, 1], or None on a read failure.

    FITS images are min-maxed per image, the convention train/dataset.py's
    load_sample applies, so validation during training and cli.evaluate
    score the distribution the model was trained on.  PNG/JPEG come from
    read_image, divided by 255 where they are not already in [0, 1], as
    the reference package does."""
    if img_path.endswith(".fits"):
        res = read_fits(img_path)
        if res is None:
            return None
        img = np.asarray(res[0], np.float32)
        lo, hi = float(img.min()), float(img.max())
        return (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    res = read_image(img_path)
    if res is None:
        return None
    img = np.asarray(res[0], np.float32)
    return img / 255.0 if img.max() > 1.5 else img


def detect_files(detector: BatchedDetector, paths):
    """detector.detect_many over image files read by load_eval_image ->
    ({path: raw detections, None if unreadable}, {path: (H, W)} of the
    readable ones)."""
    shapes: dict = {}

    def load(path):
        img = load_eval_image(path)
        if img is not None:
            shapes[path] = img.shape[:2]
        return img

    return detector.detect_many(paths, load), shapes


def label_path_for(img_path: str, label_dir: str | None) -> str:
    if label_dir:
        return os.path.join(label_dir, os.path.splitext(
            os.path.basename(img_path))[0] + ".txt")
    return os.path.splitext(img_path)[0].replace(
        f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}") + ".txt"


def evaluate_dataset(model, filelist, *, label_dir: str | None = None,
                     preprocessor=None, img_size: int = 640,
                     score_thr: float = 0.25, nms_iou_thr: float = 0.5,
                     pre_nms: int = 512, batch_size: int = 32,
                     soft_merge_thr: float = 0.3, hard_merge_thr: float = 0.8,
                     iou_thr: float = 0.6, max_images: int = -1,
                     class_names=CLASS_NAMES, detector=None,
                     detail_out: str = "", plot_out: str = "", device=None,
                     **engine_kwargs) -> MetricsReport:
    """Run the detector over every image of the filelist and score it.

    filelist: path of a text filelist, or a ready list of image paths.
    `detector` (a BatchedDetector) replaces the one built from `model`,
    `preprocessor`, `device` and the detection settings.  `plot_out`: the
    per-class C/R/F1 figure there, and the precision-recall curves beside
    it (<root>_pr<ext>), as the reference package writes them."""
    paths = (read_filelist(filelist) if isinstance(filelist, str)
             else list(filelist))
    if max_images > 0:
        paths = paths[:max_images]

    detector = detector or BatchedDetector(
        model, preprocessor=preprocessor, img_size=img_size,
        score_thr=score_thr, iou_thr=nms_iou_thr, pre_nms=pre_nms,
        batch_size=batch_size, device=device, **engine_kwargs)

    detections, shapes = detect_files(detector, paths)

    gt_list, pred_list = [], []
    for img_path in paths:
        det = detections.get(img_path)
        if det is None:
            continue  # unreadable image: skipped entirely (logged)
        h, w = shapes[img_path]
        gt_list.append(read_yolo_labels(
            label_path_for(img_path, label_dir), w, h, class_names))
        boxes, scores, cls, ok = det
        if not ok:
            pred_list.append({"bboxes": np.zeros((0, 4)), "labels": [],
                              "scores": []})
            continue
        boxes, scores, cls = merge_detections(
            boxes, scores, cls, soft_thr=soft_merge_thr,
            hard_thr=hard_merge_thr)
        pred_list.append({"bboxes": boxes,
                          "labels": [class_names[int(c)] for c in cls],
                          "scores": scores})

    report = compute_metrics(gt_list, pred_list, iou_thr)
    logger.info("Evaluation summary:\n%s", report.summary())
    map_report = compute_map(gt_list, pred_list)
    logger.info("Average precision:\n%s", map_report.summary())
    best = map_report.best_thresholds()
    if best:
        lines = [f"  {k}: scoreThr={t:.3f} -> F1={f:.3f} "
                 f"(P={p:.3f} R={r:.3f})"
                 for k, (t, f, p, r) in sorted(best.items())]
        logger.info("Best score thresholds (PR-F1 at IoU=0.50; the "
                    "reference hand-tunes --scoreThr):\n%s",
                    "\n".join(lines))
    report.map = map_report
    if detail_out:
        kept = [p for p in paths if detections.get(p) is not None]
        with open(detail_out, "w") as f:
            json.dump(per_image_match_detail(kept, gt_list, pred_list,
                                             iou_thr), f, indent=2)
        logger.info("Wrote per-image match detail to %s", detail_out)
    if plot_out:
        from caesar_yolo_tpu_torch.evaluation.metrics import (
            save_pr_figure,
            save_report_figure,
        )
        save_report_figure(report, plot_out)
        logger.info("Wrote metrics figure to %s", plot_out)
        if map_report.pr_curves:
            root, ext = os.path.splitext(plot_out)
            pr_path = f"{root}_pr{ext or '.png'}"
            save_pr_figure(map_report, pr_path)
            logger.info("Wrote PR-curve figure to %s", pr_path)
    return report
