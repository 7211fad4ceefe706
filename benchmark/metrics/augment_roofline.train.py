"""K8 (csrc/shift.cu, both routes) against its memory roofline over the
traced steps: each shear pass reads the augmentation canvas once and
writes it once in f32 (the x-shear and the y-shear, two a step; the
canvas [B, S + 2m, S + 2m, 3], m = int(0.35 S) + 2), over the device time
of the kernels named here."""

from counts.model import plane_bytes, share
from harness.trace import by_name

LAYER = "augmentation (train/augment.py, csrc/shift.cu)"
SOURCE = "device_trace"
MOVES = "train_images_per_s"
UNIT = "%"
KERNELS = ("row_shift_kernel", "col_shift_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, launches = by_name(ctx.trace, KERNELS)
    if not launches:
        return None
    size = ctx.cell.config["imgsz"]
    side = size + 2 * (int(0.35 * size) + 2)
    b = ctx.cell.params["batch"]
    return share(launches * plane_bytes(b * 3, side, side, 2), seconds)
