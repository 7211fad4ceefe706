"""Share of the traced training steps' wall in which no operation ran on
the device: 1 - (union of the device's operation intervals) / traced
wall."""

LAYER = "device"
SOURCE = "device_trace"
MOVES = "train_images_per_s"
UNIT = "%"


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
