"""Histogram equalisation of tile planes (kernel K6).

Counterpart of caesar_yolo_tpu/ops/pallas_histeq.py: skimage
equalize_hist with 256 bins over each plane's [min, max], the third
channel of the chan3 chain.

On a CUDA tensor `equalize_hist_batch` launches the hand-written kernel
in csrc/histeq.cu (see the source for its design and bound).  `plan`
picks its route by the plane's size alone: the cluster route, one launch
a call, holds each plane in the shared memory of one thread-block
cluster and reads it from device memory once; a plane too large for it
takes the stream route, four launches that read it three times.  On a
CPU tensor it runs `ops.histeq.equalize_hist`, the same arithmetic in
PyTorch; both give the same bits.  Under torch.export
`equalize_hist_batch` calls the op caesar_yolo::equalize_hist
(utils/portable.py), whose body is the same dispatch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from caesar_yolo_tpu_torch import cuda_build
from caesar_yolo_tpu_torch.ops.histeq import NBINS, equalize_hist
from caesar_yolo_tpu_torch.utils import portable

# The kernel's configuration (csrc/histeq.cu), chosen by measurement on an
# H100 (scripts/torch_kernel_tune.py, PERF.md): clusters of up to CLUSTER
# blocks of CLUSTER_THREADS threads; a plane is spread so that a block
# holds about BLOCK_VALUES values, and at most MAX_BLOCK_VALUES (192 KB of
# the 227 KB of shared memory a block may use; the rest holds the per-warp
# histograms).
CLUSTER = 16
CLUSTER_THREADS = 512
BLOCK_VALUES = 16384
MAX_BLOCK_VALUES = 49152
STREAM_THREADS = 256    # fixed in the source; the stream route's launches
UNSCHEDULABLE = -1      # the C entry point's code for a refused cluster


def plan(hw: int, max_cluster: int = CLUSTER) -> tuple[str, int, int]:
    """(route, cluster size, threads a block) for planes of hw values, by
    size alone: "cluster" holds the plane in the cluster's shared memory,
    the smallest power-of-two cluster (up to max_cluster) that gives each
    block at most BLOCK_VALUES values; "stream", for planes of more than
    max_cluster * MAX_BLOCK_VALUES values, reads them from device memory
    three times."""
    if hw > max_cluster * MAX_BLOCK_VALUES:
        return "stream", max_cluster, STREAM_THREADS
    cluster = 1
    while cluster < max_cluster and -(-hw // cluster) > BLOCK_VALUES:
        cluster *= 2
    return "cluster", cluster, CLUSTER_THREADS


def equalize_hist_batch(planes: torch.Tensor) -> torch.Tensor:
    """planes [P, H, W] f32 -> equalised f32 [P, H, W] in [0, 1].
    CUDA tensors launch the kernel on the route `plan` picks (one call
    counted in `equalize_hist_batch.launches` and in the route's counter
    `cluster_launches` or `stream_launches`); CPU tensors take
    `equalize_hist`."""
    if portable.exporting():
        return torch.ops.caesar_yolo.equalize_hist(planes)
    if not planes.is_cuda:
        return equalize_hist(planes)
    if (planes.ndim != 3 or planes.dtype != torch.float32
            or planes.shape[0] > 65535):
        raise ValueError(f"hist-eq kernel does not take planes "
                         f"{tuple(planes.shape)} {planes.dtype} (it reads up "
                         f"to 65535 f32 planes [P, H, W])")
    if planes[0].numel() > cuda_build.MAX_PLANE:
        raise cuda_build.plane_limit_error("hist-eq kernel", planes[0].numel())
    return launch(planes, *plan(planes[0].numel()))


def launch(planes, route, cluster, threads):
    """One call of the kernel on CUDA planes [P, H, W] f32 with the given
    route, cluster size and block size (`equalize_hist_batch` passes
    `plan`'s)."""
    p = planes.shape[0]
    planes = planes.contiguous()
    out = torch.empty_like(planes)
    stream = route == "stream"
    lims = hist = None
    if stream:  # scratch: limits [P, 3] and histograms [P, 256]
        lims = torch.empty((p, 3), dtype=torch.int32, device=planes.device)
        hist = torch.empty((p, NBINS), dtype=torch.int32,
                           device=planes.device)
        equalize_hist_batch.stream_launches += 1
    else:
        equalize_hist_batch.cluster_launches += 1
    equalize_hist_batch.launches += 1
    code = _entry()(planes.data_ptr(), out.data_ptr(),
                    lims.data_ptr() if stream else None,
                    hist.data_ptr() if stream else None, p,
                    planes[0].numel(), cluster, threads, int(stream),
                    cuda_build.stream_ptr(planes.device))
    if code == UNSCHEDULABLE:
        raise RuntimeError(f"hist-eq kernel: a cluster of {cluster} blocks "
                           f"of {threads} threads cannot be scheduled")
    cuda_build.check(code, "hist-eq kernel")
    return out


@functools.cache
def _entry():
    """The C entry point, its argument types set once."""
    fn = cuda_build.load("histeq").cy_equalize_hist
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


cuda_build.counters(equalize_hist_batch,
                    "launches", "cluster_launches", "stream_launches")


@torch.library.custom_op("caesar_yolo::equalize_hist", mutates_args=())
def _equalize_hist_op(planes: torch.Tensor) -> torch.Tensor:
    return equalize_hist_batch(planes).contiguous()


@_equalize_hist_op.register_fake
def _(planes):
    return planes.new_empty(planes.shape, dtype=torch.float32)
