"""Faults planted under a run's timed path, to read what the check makes
of them (`run.py --variant fault:<name>`, for benchmark/tests and the
limits' readings; never a measured run).  Each wraps one function of the
program until the run ends.
"""

from __future__ import annotations

import importlib


def _drop_half_tiles(real):
    """Half of each device batch's tiles left out (no detections)."""
    def process_mosaic_async(self, *args, **kwargs):
        boxes, scores, cls, valid, ok, ndrop = real(self, *args, **kwargs)
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = False
        return boxes, scores, cls, valid, ok, ndrop
    return process_mosaic_async


def _moved_boxes(real):
    """Every box moved by 40 px where the engine produces it."""
    def process_mosaic_async(self, *args, **kwargs):
        boxes, *rest = real(self, *args, **kwargs)
        return (boxes + 40.0, *rest)
    return process_mosaic_async


def _half_batch(real):
    """Half of each training batch left out, the mean over the rest."""
    def train_step(self, images, labels, boxes, masks):
        h = images.shape[0] // 2
        return real(self, images[:h], labels[:h], boxes[:h], masks[:h])
    return train_step


def _moved_targets(real):
    """The targets moved by 8 px where the augmentation produces them."""
    def augment_batch(*args):
        imgs, boxes, masks = real(*args)
        return imgs, boxes + 8.0, masks
    return augment_batch


FAULTS = {
    "drop_half_tiles": ("caesar_yolo_tpu_torch.parallel.engine",
                        "TileEngine.process_mosaic_async", _drop_half_tiles),
    "moved_boxes": ("caesar_yolo_tpu_torch.parallel.engine",
                    "TileEngine.process_mosaic_async", _moved_boxes),
    "half_batch": ("caesar_yolo_tpu_torch.train.trainer",
                   "Trainer.train_step", _half_batch),
    "moved_targets": ("caesar_yolo_tpu_torch.train.augment",
                      "augment_batch", _moved_targets),
}


def plant(name: str):
    """Plant the fault; returns the function that takes it out."""
    module, path, wrap = FAULTS[name]
    owner = importlib.import_module(module)
    *outer, attr = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    real = getattr(owner, attr)
    setattr(owner, attr, wrap(real))
    return lambda: setattr(owner, attr, real)
