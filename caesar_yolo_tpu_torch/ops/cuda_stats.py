"""Sigma-clipped statistics of tile planes (kernel K5).

Counterpart of caesar_yolo_tpu/ops/pallas_stats.py.  For each plane:
the astropy-default sigma-clipped (mean, median, std, lower, upper,
n_valid) over the valid pixels (finite and != 0), with an exact median
(see ops/stats.py for the algorithm).  Used by the background
subtraction and both clips of the chan3 chain.

On a CUDA tensor `clip_stats` launches the hand-written kernel in
csrc/stats.cu: one thread-block cluster per plane, four bisection rounds
a pass (see the source for its design and bound).  `plan` picks its
route by the plane's size alone: the cluster route holds each plane in
the cluster's shared memory; a plane too large for it takes the stream
route, which reads it from device memory on every pass.  On a CPU tensor
it runs `ops.stats.clip_stats_plain`, the same arithmetic in PyTorch.
The kernel derives the mask from the values, so an explicit mask is
taken on the CPU only.  Under torch.export `clip_stats` calls the op
caesar_yolo::clip_stats (utils/portable.py), whose body is the same
dispatch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from caesar_yolo_tpu_torch import cuda_build
from caesar_yolo_tpu_torch.ops.stats import clip_stats_plain
from caesar_yolo_tpu_torch.utils import portable


# The kernel's configuration (csrc/stats.cu), chosen by measurement on an
# H100 (scripts/torch_kernel_tune.py, PERF.md): clusters of up to CLUSTER
# blocks; a plane of the cluster route is spread so that a block holds
# about BLOCK_VALUES values, and at most MAX_BLOCK_VALUES (208 KB of the
# 227 KB of shared memory a block may use; the rest holds the
# reductions), in blocks of CLUSTER_THREADS threads; the stream route
# runs blocks of STREAM_THREADS.
CLUSTER = 16
CLUSTER_THREADS = 512
STREAM_THREADS = 1024
BLOCK_VALUES = 16384
MAX_BLOCK_VALUES = 53248
UNSCHEDULABLE = -1      # the C entry point's code for a refused cluster


def plan(hw: int, max_cluster: int = CLUSTER) -> tuple[str, int, int]:
    """(route, cluster size, threads a block) for planes of hw values, by
    size alone: "cluster" holds the plane in the cluster's shared memory,
    the smallest power-of-two cluster (up to max_cluster) that gives each
    block at most BLOCK_VALUES values; "stream", for planes of more than
    max_cluster * MAX_BLOCK_VALUES values, reads them from device
    memory on every pass."""
    if hw > max_cluster * MAX_BLOCK_VALUES:
        return "stream", max_cluster, STREAM_THREADS
    cluster = 1
    while cluster < max_cluster and -(-hw // cluster) > BLOCK_VALUES:
        cluster *= 2
    return "cluster", cluster, CLUSTER_THREADS


def clip_stats(values: torch.Tensor, sigma_low: float, sigma_up: float,
               maxiters: int = 5, mask: torch.Tensor | None = None):
    """values [P, H, W] f32 -> (stats [P, 5] f32 = mean, median, std,
    lower, upper; counts [P, 2] int32 = n_valid, final kept count).
    CUDA tensors launch the kernel on the route `plan` picks (one launch a
    call, counted in `clip_stats.launches` and in the route's counter
    `clip_stats.cluster_launches` or `clip_stats.stream_launches`); CPU
    tensors take `clip_stats_plain` (where `mask` may replace the values'
    own valid mask)."""
    if portable.exporting():
        return torch.ops.caesar_yolo.clip_stats(
            values, float(sigma_low), float(sigma_up), int(maxiters), mask)
    if not values.is_cuda:
        return clip_stats_plain(values, mask, sigma_low, sigma_up, maxiters)
    if (mask is not None or values.ndim != 3
            or values.dtype != torch.float32 or values.shape[0] > 65535):
        raise ValueError(
            f"sigma-clip kernel does not take values {tuple(values.shape)} "
            f"{values.dtype}{' with an explicit mask' if mask is not None else ''}"
            f" (it reads up to 65535 f32 planes [P, H, W] and derives their "
            f"mask)")
    if values[0].numel() > cuda_build.MAX_PLANE:
        raise cuda_build.plane_limit_error("sigma-clip kernel",
                                           values[0].numel())
    return launch(values, sigma_low, sigma_up, maxiters,
                  *plan(values[0].numel()))


def launch(values, sigma_low, sigma_up, maxiters, route, cluster, threads):
    """One launch of the kernel on CUDA planes [P, H, W] f32 with the given
    route, cluster size and block size (`clip_stats` passes `plan`'s)."""
    p = values.shape[0]
    hw = values[0].numel()
    values = values.contiguous()
    stats = torch.empty((p, 5), dtype=torch.float32, device=values.device)
    counts = torch.empty((p, 2), dtype=torch.int32, device=values.device)
    clip_stats.launches += 1
    if route == "stream":
        clip_stats.stream_launches += 1
    else:
        clip_stats.cluster_launches += 1
    code = _entry()(values.data_ptr(), stats.data_ptr(), counts.data_ptr(),
                    p, hw, float(sigma_low), float(sigma_up), int(maxiters),
                    cluster, threads, int(route == "stream"),
                    cuda_build.stream_ptr(values.device))
    if code == UNSCHEDULABLE:
        raise RuntimeError(f"sigma-clip kernel: a cluster of {cluster} blocks "
                           f"of {threads} threads cannot be scheduled")
    cuda_build.check(code, "sigma-clip kernel")
    return stats, counts


@functools.cache
def _entry():
    """The C entry point, its argument types set once."""
    fn = cuda_build.load("stats").cy_sigma_clip_stats
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int64]
                   + [ctypes.c_float] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


cuda_build.counters(clip_stats,
                    "launches", "cluster_launches", "stream_launches")


@torch.library.custom_op("caesar_yolo::clip_stats", mutates_args=())
def _clip_stats_op(values: torch.Tensor, sigma_low: float, sigma_up: float,
                   maxiters: int, mask: torch.Tensor | None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    stats, counts = clip_stats(values, sigma_low, sigma_up, maxiters, mask)
    return stats.contiguous(), counts.contiguous()


@_clip_stats_op.register_fake
def _(values, sigma_low, sigma_up, maxiters, mask):
    p = values.shape[0]
    return (values.new_empty((p, 5), dtype=torch.float32),
            values.new_empty((p, 2), dtype=torch.int32))


# The kernel against its plain version: n_valid equal; where the final
# kept counts agree, the median exactly (the same bisection and pin) and
# mean, std, lower and upper within STATS_RTOL of the largest magnitude
# among the plane's five statistics (f32 sums in another order; a bound
# near zero is the difference of two larger numbers).  A kept count may
# differ by at most KEPT_SLACK pixels, when a pixel lies at rounding
# distance from a bound; such a plane's statistics move by about one
# pixel's weight, so they are held within KEPT_RTOL instead.
STATS_RTOL = 1e-5
KEPT_SLACK = 2
KEPT_RTOL = 1e-3


def stats_mismatch(got, ref) -> str | None:
    """got, ref: (stats [P, 5], counts [P, 2]) of the kernel and of
    `clip_stats_plain` on the same planes -> None when they agree by the
    rule above, else what differs."""
    gs, gc = (t.detach().cpu() for t in got)
    rs, rc = (t.detach().cpu() for t in ref)
    if not torch.equal(gc[:, 0], rc[:, 0]):
        return "n_valid differs"
    if not torch.equal(gs.isnan(), rs.isnan()):
        return "NaN statistics differ"
    dkept = (gc[:, 1] - rc[:, 1]).abs()
    if bool((dkept > KEPT_SLACK).any()):
        return f"kept counts differ by {int(dkept.max())}"
    same = dkept == 0
    if not torch.equal(gs[same, 1].nan_to_num(), rs[same, 1].nan_to_num()):
        return "median differs where the kept sets agree"
    scale = rs.nan_to_num().abs().amax(dim=1, keepdim=True)
    err = (gs - rs).nan_to_num().abs()
    tol = torch.where(same[:, None], STATS_RTOL, KEPT_RTOL) * scale
    if bool((err > tol).any()):
        bad = (err / scale.clamp(min=1e-30)).max().item()
        return f"statistics differ by {bad:.3g} of the plane's scale"
    return None
