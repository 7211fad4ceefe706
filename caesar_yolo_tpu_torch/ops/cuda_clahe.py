"""CLAHE of planes (kernel K7).

Counterpart of caesar_yolo_tpu/ops/pallas_clahe.py:equalize_adapthist_batch,
the adaptive branch of hist_equalizer.  On a CUDA tensor
`equalize_adapthist_batch` launches the hand-written kernel in
csrc/clahe.cu (see the source for its design and bound).  `plan` picks its
route by the plane's size alone: the cluster route, one launch a call,
walks the planes with persistent thread-block clusters that hold each
plane in their shared memory (the next plane's copy in flight), build the
tables there and read the plane from device memory once; a plane too
large for it takes the stream route, four launches (the range, the tile
histograms, the tables, the blend).  On a CPU tensor it runs
ops/clahe.equalize_adapthist_plain, the same arithmetic in PyTorch; both
give the same bits.  `tile_histograms` and `blend` launch the stream
route's histogram and blend kernels one at a time, each with a range the
caller gives.  Under torch.export `equalize_adapthist_batch` calls the
op caesar_yolo::equalize_adapthist (utils/portable.py), whose body is the
same dispatch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from caesar_yolo_tpu_torch import cuda_build
from caesar_yolo_tpu_torch.ops.clahe import (
    GRID,
    NBINS,
    _blend_coords,
    blend_plain,
    clip_limit_count,
    equalize_adapthist_plain,
    tile_histograms_plain,
    tile_size,
)
from caesar_yolo_tpu_torch.utils import portable

# The kernel's configuration (csrc/clahe.cu), chosen by measurement on an
# H100 (scripts/torch_kernel_tune.py, PERF.md): clusters of up to CLUSTER
# blocks of 1024 threads (fixed in the source); a plane is spread so that a
# block holds about BLOCK_VALUES values in whole rows, as long as a block's
# shared memory (its rows' values and bins, its tile rows of counts and of
# tables, the taps) stays within SMEM_BYTES (the 227 KB a block may use
# less the kernel's static part).
CLUSTER = 16
BLOCK_VALUES = 16384
SMEM_BYTES = 227 * 1024 - 1024
UNSCHEDULABLE = -1      # the C entry point's code for a refused cluster


def block_windows(h: int, w: int, rows: int, grid: int = GRID):
    """For each block of `rows` rows (the last may hold fewer; blocks past
    the plane hold none and are left out): (the tile rows it counts into,
    the tile rows its blend taps reach), each as (first, last).  A block
    counts into its rows' own tile rows and into those of the pad rows
    that reflect onto its rows (csrc/clahe.cu)."""
    th, _ = tile_size(h, w, grid)
    padh = grid * th - h
    t0, t1, _ = _blend_coords(h, th, grid, "cpu")
    out = []
    for r0 in range(0, h, rows):
        r1 = min(h, r0 + rows) - 1
        ha, hb = r0 // th, r1 // th
        ylo, yhi = max(r0, h - 1 - padh), min(r1, h - 2)
        if ylo <= yhi:
            ha = min(ha, (2 * (h - 1) - yhi) // th)
            hb = max(hb, (2 * (h - 1) - ylo) // th)
        out.append(((ha, hb), (int(t0[r0]), int(t1[r1]))))
    return out


@functools.lru_cache(maxsize=64)
def layout(h: int, w: int, cluster: int, grid: int = GRID):
    """(rows a block holds, tile rows of its count and table buffers, its
    shared memory in bytes) for planes [h, w] on clusters of `cluster`
    blocks, as csrc/clahe.cu carves it (its `Carve` and `block_window`: the
    C entry point refuses a layout that differs)."""
    rows = -(-h // cluster)
    win = max(max(hb - ha, cb - ca) + 1
              for (ha, hb), (ca, cb) in block_windows(h, w, rows, grid))
    w4 = (w + 3) // 4 * 4
    words = ((rows * w + 3) // 4 * 4 + 2 * win * grid * NBINS + 5 * rows
             + 3 * w4)
    return rows, win, 4 * words + (rows * w + 15) // 16 * 16


@functools.lru_cache(maxsize=64)
def plan(h: int, w: int, grid: int = GRID):
    """(route, cluster size, rows a block, tile rows of counts and of
    tables a block) for planes [h, w], by size alone: "cluster", the
    smallest power-of-two cluster (up to CLUSTER) whose blocks hold at
    most BLOCK_VALUES values, while a block's shared memory fits; "stream"
    (cluster, rows and tile rows 0) for planes whose blocks would not fit
    even at CLUSTER."""
    tile_size(h, w, grid)
    cluster = 1
    while cluster < CLUSTER and -(-h // cluster) * w > BLOCK_VALUES:
        cluster *= 2
    rows, win, smem = layout(h, w, cluster, grid)
    if smem > SMEM_BYTES:
        return "stream", 0, 0, 0
    return "cluster", cluster, rows, win


def equalize_adapthist_batch(planes: torch.Tensor, clip_limit: float = 0.03,
                             grid: int = GRID) -> torch.Tensor:
    """planes [P, H, W] -> CLAHE f32 [P, H, W] in [0, 1].  CUDA tensors
    launch the kernel on the route `plan` picks (one call counted in
    `equalize_adapthist_batch.launches` and in the route's counter
    `cluster_launches` or `stream_launches`); CPU tensors take
    ops/clahe.equalize_adapthist_plain."""
    planes = planes.float()
    if portable.exporting():
        return torch.ops.caesar_yolo.equalize_adapthist(
            planes, float(clip_limit), int(grid))
    if not planes.is_cuda:
        return equalize_adapthist_plain(planes, clip_limit, grid)
    if planes.ndim != 3 or planes.shape[0] > 65535:
        raise ValueError(f"CLAHE kernel does not take planes "
                         f"{tuple(planes.shape)} (it reads up to 65535 "
                         f"planes [P, H, W])")
    return launch(planes, clip_limit, grid, *plan(*planes.shape[1:], grid))


def launch(planes, clip_limit, grid, route, cluster, rows, win):
    """One call of the kernel on CUDA planes [P, H, W] f32 with the given
    route and configuration (`equalize_adapthist_batch` passes `plan`'s)."""
    planes = planes.contiguous()
    p, h, w = planes.shape
    th, tw = tile_size(h, w, grid)
    out = torch.empty_like(planes)
    stream = route == "stream"
    scratch = None
    if stream:  # the tables [P, grid*grid, 256], then vmin and span [2P]
        scratch = torch.empty(p * grid * grid * NBINS + 2 * p,
                              device=planes.device)
        equalize_adapthist_batch.stream_launches += 1
    else:
        equalize_adapthist_batch.cluster_launches += 1
    equalize_adapthist_batch.launches += 1
    smem = 0 if stream else layout(h, w, cluster, grid)[2]
    vec = w % 4 == 0 and planes.data_ptr() % 16 == 0
    code = _entry()(planes.data_ptr(), out.data_ptr(),
                    scratch.data_ptr() if stream else None, p, h, w, grid,
                    th, tw, clip_limit_count(th * tw, clip_limit), cluster,
                    rows, win, smem, int(vec), int(stream),
                    cuda_build.stream_ptr(planes.device))
    if code == UNSCHEDULABLE:
        raise RuntimeError(f"CLAHE kernel: a cluster of {cluster} blocks "
                           f"cannot be scheduled")
    cuda_build.check(code, "CLAHE kernel")
    return out


@functools.cache
def _entry():
    """The C entry point, its argument types set once."""
    fn = cuda_build.load("clahe").cy_clahe
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


cuda_build.counters(equalize_adapthist_batch,
                    "launches", "cluster_launches", "stream_launches")


@torch.library.custom_op("caesar_yolo::equalize_adapthist", mutates_args=())
def _equalize_adapthist_op(planes: torch.Tensor, clip_limit: float,
                           grid: int) -> torch.Tensor:
    return equalize_adapthist_batch(planes, clip_limit, grid).contiguous()


@_equalize_adapthist_op.register_fake
def _(planes, clip_limit, grid):
    return planes.new_empty(planes.shape, dtype=torch.float32)


# The stream route's histogram and blend kernels, one launch each, with
# the plane range the caller gives (ops/clahe.value_range); the route itself
# launches them from its C entry point, with its own range launch.

def _check(planes, vmin, span):
    if (planes.ndim != 3 or planes.dtype != torch.float32
            or vmin.shape != (planes.shape[0],) or span.shape != vmin.shape
            or vmin.dtype != torch.float32 or span.dtype != torch.float32):
        raise ValueError(f"CLAHE kernel does not take planes "
                         f"{tuple(planes.shape)} {planes.dtype} with range "
                         f"{tuple(vmin.shape)} {vmin.dtype}")
    return planes.contiguous(), vmin.contiguous(), span.contiguous()


def tile_histograms(planes: torch.Tensor, vmin: torch.Tensor,
                    span: torch.Tensor, grid: int = GRID) -> torch.Tensor:
    """planes [P, H, W] f32 -> f32 counts [P, grid*grid, 256] of the
    contextual tiles.  CUDA tensors launch the stream route's histogram
    kernel; CPU tensors take `tile_histograms_plain`."""
    if not planes.is_cuda:
        return tile_histograms_plain(planes, vmin, span, grid)
    planes, vmin, span = _check(planes, vmin, span)
    p, h, w = planes.shape
    th, tw = tile_size(h, w, grid)
    hist = torch.empty((p, grid * grid, NBINS), dtype=torch.float32,
                       device=planes.device)
    fn = cuda_build.load("clahe").cy_clahe_hist
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tile_histograms.launches += 1
    cuda_build.check(fn(planes.data_ptr(), vmin.data_ptr(), span.data_ptr(),
                        hist.data_ptr(), p, h, w, grid, th, tw,
                        cuda_build.stream_ptr(planes.device)),
                     "CLAHE histogram kernel")
    return hist


def blend(planes: torch.Tensor, vmin: torch.Tensor, span: torch.Tensor,
          cdf: torch.Tensor, grid: int = GRID) -> torch.Tensor:
    """Each pixel through the bilinear blend of its 4 neighbouring tiles'
    CDFs [P, grid*grid, 256] -> f32 [P, H, W].  CUDA tensors launch the
    stream route's blend kernel; CPU tensors take `blend_plain`."""
    if not planes.is_cuda:
        return blend_plain(planes, vmin, span, cdf, grid)
    planes, vmin, span = _check(planes, vmin, span)
    p, h, w = planes.shape
    if cdf.shape != (p, grid * grid, NBINS) or cdf.dtype != torch.float32:
        raise ValueError(f"CLAHE blend kernel does not take tables "
                         f"{tuple(cdf.shape)} {cdf.dtype}")
    th, tw = tile_size(h, w, grid)
    cdf = cdf.contiguous()
    out = torch.empty_like(planes)
    fn = cuda_build.load("clahe").cy_clahe_blend
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blend.launches += 1
    cuda_build.check(fn(planes.data_ptr(), vmin.data_ptr(), span.data_ptr(),
                        cdf.data_ptr(), out.data_ptr(), p, h, w, grid, th, tw,
                        cuda_build.stream_ptr(planes.device)),
                     "CLAHE blend kernel")
    return out


cuda_build.counters(tile_histograms, "launches")
cuda_build.counters(blend, "launches")
