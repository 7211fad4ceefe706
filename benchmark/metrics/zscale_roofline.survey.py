"""K3 (csrc/preproc.cu, cluster route) against its memory roofline over
the traced fields: each batch's tile planes read once and written once in
f32 (the zscale + min-max chain) over the device time of the kernel."""

from counts.model import plane_bytes, share
from harness.trace import by_name

LAYER = "kernels (csrc/*.cu)"
SOURCE = "device_trace"
MOVES = "survey_tiles_per_s"
UNIT = "%"
KERNELS = ("zscale_cluster_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, launches = by_name(ctx.trace, KERNELS)
    if not launches:
        return None
    nbytes = ctx.trace.units * sum(plane_bytes(ctx.batch_size, h, w, 2)
                                   for h, w in ctx.batches)
    return share(nbytes, seconds)
