"""K10 (csrc/epilogue.cu) against its memory roofline over the traced
fields: the bytes of every bf16 conv epilogue of each forward (the f32
conv output read once, the bf16 result written once, the per-channel
shift; counts/model.py from the reference's conv shapes) over the device
time of the kernels named here."""

from counts.model import epilogue_bytes, share
from harness.trace import by_name

LAYER = "kernels (csrc/*.cu)"
SOURCE = "device_trace"
MOVES = "survey_tiles_per_s"
UNIT = "%"
KERNELS = ("epilogue_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, launches = by_name(ctx.trace, KERNELS)
    if not launches:
        return None
    cfg = ctx.cell.config
    forwards = ctx.trace.units * len(ctx.batches)
    b = ctx.batch_size
    return share(forwards * epilogue_bytes(cfg["model"], cfg["nc"], b,
                                           cfg["imgsz"]), seconds)
