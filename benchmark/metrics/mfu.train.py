"""The training window's share of the card's bf16 peak: the reference
model's forward and backward FLOPs an image at the training size
(counts/model.py), times the images stepped, over the window's wall, over
989 TFLOP/s."""

from counts.model import PEAKS, model_flops

LAYER = "training step (train/trainer.py, train/loss.py, models/layers.py)"
SOURCE = "host_clock"
MOVES = "train_images_per_s"
UNIT = "%"


def read(ctx):
    cfg = ctx.cell.config
    images = sum(u["images"] for u in ctx.units)
    if not images or ctx.window_s <= 0:
        return None
    flops = model_flops(cfg["model"], cfg["nc"], cfg["imgsz"], True)
    return 100.0 * flops * images / ctx.window_s / PEAKS["bf16_flops_per_s"]
