"""K5 (csrc/stats.cu) against its memory roofline over the traced fields:
each launch's f32 planes read once (the background's clip and the two
chan3 clips: three launches a batch) over the device time of the
kernel."""

from counts.model import plane_bytes, share
from harness.trace import by_name

LAYER = "kernels (csrc/*.cu)"
SOURCE = "device_trace"
MOVES = "survey_tiles_per_s"
UNIT = "%"
KERNELS = ("clip_stats_cluster_kernel",)
LAUNCHES_PER_BATCH = 3


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, launches = by_name(ctx.trace, KERNELS)
    if not launches:
        return None
    nbytes = ctx.trace.units * LAUNCHES_PER_BATCH * sum(
        plane_bytes(ctx.batch_size, h, w, 1) for h, w in ctx.batches)
    return share(nbytes, seconds)
