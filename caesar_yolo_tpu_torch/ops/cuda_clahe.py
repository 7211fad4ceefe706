"""CLAHE of planes (kernel K7).

Counterpart of caesar_yolo_tpu/ops/pallas_clahe.py:equalize_adapthist_batch,
the adaptive branch of hist_equalizer.  `tile_histograms` and `blend` are
the kernel's two launches (csrc/clahe.cu; see the source for its design
and bound); between them the plane range, clip + redistribution and the
CDFs run in PyTorch on both routes (ops/clahe.py).  On a CUDA tensor each
wrapper launches its kernel; on a CPU tensor it runs the plain version in
ops/clahe.py, the same arithmetic in PyTorch; both give the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from caesar_yolo_tpu_torch import cuda_build
from caesar_yolo_tpu_torch.ops.clahe import (
    GRID,
    NBINS,
    blend_plain,
    cdf_tables,
    tile_histograms_plain,
    tile_size,
    value_range,
)


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
    contextual tiles.  CUDA tensors launch the kernel; CPU tensors take
    `tile_histograms_plain`."""
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
    kernel; CPU tensors take `blend_plain`."""
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


tile_histograms.launches = 0
blend.launches = 0


def equalize_adapthist_batch(planes: torch.Tensor, clip_limit: float = 0.03,
                             grid: int = GRID) -> torch.Tensor:
    """planes [P, H, W] -> CLAHE f32 [P, H, W] in [0, 1]: K7's two launches
    on CUDA tensors, ops/clahe.equalize_adapthist_plain's arithmetic on CPU
    ones."""
    planes = planes.float().contiguous()
    th, tw = tile_size(*planes.shape[1:], grid)
    vmin, span = value_range(planes)
    hist = tile_histograms(planes, vmin, span, grid)
    return blend(planes, vmin, span, cdf_tables(hist, th * tw, clip_limit),
                 grid)
