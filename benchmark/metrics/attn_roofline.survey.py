"""K2 (csrc/attn.cu) against its roofline over the traced fields: the
attention of every forward (counts/attn.py: 2 N^2 (kd + hd) FLOPs a
sequence-head; q, k, v and the output once in bf16, from the reference
model's attention calls) over the device time of the kernel named here,
the larger of the memory and the bf16 peak's bound.  None where K2 did
not run."""

from counts.attn import attention_work
from counts.model import share
from harness.trace import by_name

LAYER = "kernels (csrc/*.cu)"
SOURCE = "device_trace"
MOVES = "survey_tiles_per_s"
UNIT = "%"
KERNELS = ("attn_fwd_mma_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, launches = by_name(ctx.trace, KERNELS)
    if not launches:
        return None
    cfg = ctx.cell.config
    flops, nbytes = attention_work(cfg["model"], cfg["nc"], ctx.batch_size,
                                   cfg["imgsz"])
    forwards = ctx.trace.units * len(ctx.batches)
    return share(forwards * nbytes, seconds, forwards * flops)
