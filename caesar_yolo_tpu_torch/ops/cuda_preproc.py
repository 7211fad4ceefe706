"""Fused zscale + min-max normalisation (kernel K3).

Counterpart of caesar_yolo_tpu/ops/pallas_preproc.py.  For each plane:
zscale stretch with its (vmin, vmax) from `zscale_limits` (computed
outside the kernel, as in the reference), the masked min/max of the
stretched values, and normalisation to [norm_min, norm_max].  Returns
(out, valid) with valid = isfinite(zmin) & (zmax > zmin), the
reference's predicate (pallas_preproc.py:114).

On a CUDA tensor it launches the hand-written kernel in
csrc/preproc.cu (see the source for its design and bound).  `plan` picks
its route by the plane's size alone: the cluster route, one launch a
call, walks the planes with persistent thread-block clusters that read
each plane's parts into shared memory once (the next plane's copy in
flight) and write it once; a plane whose parts are too large for a
block's shared memory takes the stream route, three launches that read it
twice.  On a CPU
tensor it runs `zscale_minmax_plain`, the same chain in PyTorch; both
give the same bits.  Under torch.export `zscale_minmax` calls the op
caesar_yolo::zscale_minmax (utils/portable.py), whose body is the same
dispatch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from caesar_yolo_tpu_torch import cuda_build
from caesar_yolo_tpu_torch.ops.stats import valid_mask
from caesar_yolo_tpu_torch.ops.zscale import zscale_apply, zscale_limits
from caesar_yolo_tpu_torch.utils import portable

# The kernel's configuration (csrc/preproc.cu), chosen by measurement on an
# H100 (scripts/torch_kernel_tune.py, PERF.md): clusters of up to CLUSTER
# blocks, each block holding its part of a plane in one shared buffer; a
# plane is spread so that a block holds about BLOCK_VALUES values, and at
# most MAX_BLOCK_VALUES (208 KB of the 227 KB of shared memory a block may
# use); a block's part is copied in one bulk copy for each SEGMENT_VALUES
# values (at least one, at most MAX_SEGMENTS).
CLUSTER = 16
BLOCK_VALUES = 8192
MAX_BLOCK_VALUES = 53248
SEGMENT_VALUES = 12800
MAX_SEGMENTS = 8
UNSCHEDULABLE = -1      # the C entry point's code for a refused cluster
ENTRY_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int64]
              + [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def chunk(hw: int, cluster: int) -> int:
    """Values of a plane of hw values that each block of a cluster holds
    (the last blocks' parts may be short or empty): a multiple of 4, so
    that every part of an aligned plane is 16-byte aligned."""
    return (-(-hw // cluster) + 3) // 4 * 4


def plan(hw: int, max_cluster: int = CLUSTER) -> tuple[str, int, int]:
    """(route, cluster size, segments) for planes of hw values, by size
    alone: "cluster", the smallest power-of-two cluster (up to
    max_cluster) that gives each block at most BLOCK_VALUES values, with a
    bulk copy for each SEGMENT_VALUES values of a part; "stream" (no
    segments) for planes whose part would exceed MAX_BLOCK_VALUES even at
    max_cluster blocks."""
    if chunk(hw, max_cluster) > MAX_BLOCK_VALUES:
        return "stream", max_cluster, 0
    cluster = 1
    while cluster < max_cluster and chunk(hw, cluster) > BLOCK_VALUES:
        cluster *= 2
    segments = min(MAX_SEGMENTS, max(1, chunk(hw, cluster) // SEGMENT_VALUES))
    return "cluster", cluster, segments


def minmax_apply(z: torch.Tensor, norm_min: float, norm_max: float):
    """Masked min-max normalisation of planes z [P, ...] -> (out, zlims
    [P, 2]); masked pixels give 0."""
    cond = valid_mask(z)
    dims = tuple(range(1, z.ndim))
    lo = torch.where(cond, z, torch.inf).amin(dim=dims)
    hi = torch.where(cond, z, -torch.inf).amax(dim=dims)
    shape = (-1,) + (1,) * (z.ndim - 1)
    span = (hi - lo).reshape(shape)
    out = ((z - lo.reshape(shape)) / torch.where(span != 0, span, 1.0)
           * (norm_max - norm_min) + norm_min)
    return torch.where(cond, out, 0.0), torch.stack([lo, hi], dim=1)


def zscale_minmax_plain(planes: torch.Tensor, vlims: torch.Tensor,
                        norm_min: float = 0.0, norm_max: float = 1.0):
    """planes [P, H, W] f32, vlims [P, 2] -> (out [P, H, W], zlims [P, 2]).
    The kernel's arithmetic in PyTorch."""
    vmin = vlims[:, 0, None, None]
    vmax = vlims[:, 1, None, None]
    z = torch.where(valid_mask(planes), zscale_apply(planes, vmin, vmax), 0.0)
    return minmax_apply(z, norm_min, norm_max)


def zscale_minmax(planes: torch.Tensor, vlims: torch.Tensor,
                  norm_min: float = 0.0, norm_max: float = 1.0):
    """planes [P, H, W] f32, vlims [P, 2] f32 -> (out [P, H, W] f32,
    zlims [P, 2]).  CUDA tensors launch the kernel on the route `plan`
    picks (one call counted in `zscale_minmax.launches` and in the route's
    counter `cluster_launches` or `stream_launches`); CPU tensors take
    `zscale_minmax_plain`."""
    if portable.exporting():
        return torch.ops.caesar_yolo.zscale_minmax(
            planes, vlims, float(norm_min), float(norm_max))
    if not planes.is_cuda:
        return zscale_minmax_plain(planes, vlims, norm_min, norm_max)
    p = planes.shape[0]
    if (planes.ndim != 3 or planes.dtype != torch.float32
            or vlims.shape != (p, 2) or vlims.dtype != torch.float32):
        raise ValueError(f"zscale+minmax kernel does not take planes "
                         f"{tuple(planes.shape)} {planes.dtype}, vlims "
                         f"{tuple(vlims.shape)} {vlims.dtype}")
    hw = planes.shape[1] * planes.shape[2]
    if hw > cuda_build.MAX_PLANE:
        raise cuda_build.plane_limit_error("zscale+minmax kernel", hw)
    return launch(planes, vlims, norm_min, norm_max, *plan(hw))


def launch(planes, vlims, norm_min, norm_max, route, cluster, segments):
    """One call of the kernel on CUDA planes [P, H, W] f32 with the given
    route, cluster size and segments (`zscale_minmax` passes `plan`'s)."""
    p = planes.shape[0]
    stream = route == "stream"
    if stream and p > 65535:
        raise ValueError(f"zscale+minmax kernel's stream route does not take "
                         f"{p} planes")
    planes = planes.contiguous()
    vlims = vlims.contiguous()
    out = torch.empty_like(planes)
    zlims = torch.empty((p, 2), device=planes.device)  # set by the kernel
    zscale_minmax.launches += 1
    if stream:
        zscale_minmax.stream_launches += 1
    else:
        zscale_minmax.cluster_launches += 1
    code = _entry()(planes.data_ptr(), vlims.data_ptr(), zlims.data_ptr(),
                    out.data_ptr(), p, planes.shape[1] * planes.shape[2],
                    float(norm_min), float(norm_max), cluster, segments,
                    int(stream), cuda_build.stream_ptr(planes.device))
    if code == UNSCHEDULABLE:
        raise RuntimeError(f"zscale+minmax kernel: a cluster of {cluster} "
                           f"blocks cannot be scheduled")
    cuda_build.check(code, "zscale+minmax kernel")
    return out, zlims


@functools.cache
def _entry():
    """The C entry point, its argument types set once."""
    fn = cuda_build.load("preproc").cy_zscale_minmax
    fn.argtypes = ENTRY_ARGS
    fn.restype = ctypes.c_int
    return fn


cuda_build.counters(zscale_minmax,
                    "launches", "cluster_launches", "stream_launches")


@torch.library.custom_op("caesar_yolo::zscale_minmax", mutates_args=())
def _zscale_minmax_op(planes: torch.Tensor, vlims: torch.Tensor,
                      norm_min: float, norm_max: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    out, zlims = zscale_minmax(planes, vlims, norm_min, norm_max)
    return out.contiguous(), zlims.contiguous()


@_zscale_minmax_op.register_fake
def _(planes, vlims, norm_min, norm_max):
    return (planes.new_empty(planes.shape, dtype=torch.float32),
            planes.new_empty((planes.shape[0], 2), dtype=torch.float32))


def fused_zscale_minmax(tiles: torch.Tensor, contrast: float = 0.25,
                        norm_min: float = 0.0, norm_max: float = 1.0):
    """The README chain on planes [P, H, W] (or [P, H, W, 1]) f32 ->
    (out, valid[P]), as caesar_yolo_tpu/ops/pallas_preproc.py:
    fused_zscale_minmax: zscale limits per plane, then `zscale_minmax`."""
    squeeze = tiles.ndim == 4
    if squeeze:
        tiles = tiles[..., 0]
    tiles = tiles.float()
    vmin, vmax = zscale_limits(tiles, contrast=contrast)
    out, zlims = zscale_minmax(tiles, torch.stack([vmin, vmax], dim=1),
                               norm_min, norm_max)
    valid = torch.isfinite(zlims[:, 0]) & (zlims[:, 1] > zlims[:, 0])
    return (out[..., None] if squeeze else out), valid
