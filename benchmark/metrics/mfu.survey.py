"""The survey window's share of the card's bf16 peak: the reference
model's forward FLOPs a tile at the run's image size (counts/model.py),
times the tiles completed, over the window's wall, over 989 TFLOP/s."""

from counts.model import PEAKS, model_flops

LAYER = "model (models/yolo.py, models/layers.py)"
SOURCE = "host_clock"
MOVES = "survey_tiles_per_s"
UNIT = "%"


def read(ctx):
    cfg = ctx.cell.config
    tiles = sum(u["tiles"] for u in ctx.units if u["rc"] == 0)
    if not tiles or ctx.window_s <= 0:
        return None
    flops = model_flops(cfg["model"], cfg["nc"], cfg["imgsz"]) * tiles
    return 100.0 * flops / ctx.window_s / PEAKS["bf16_flops_per_s"]
