"""Histogram equalisation of tile planes (kernel K6).

Counterpart of caesar_yolo_tpu/ops/pallas_histeq.py: skimage
equalize_hist with 256 bins over each plane's [min, max], the third
channel of the chan3 chain.

On a CUDA tensor `equalize_hist_batch` launches the hand-written kernel
in csrc/histeq.cu (min/max, shared-memory histogram and LUT apply, each
spread over many blocks per plane; see the source for its design and
bound).  On a CPU tensor it runs `ops.histeq.equalize_hist`, the same
arithmetic in PyTorch; both give the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from caesar_yolo_tpu_torch import cuda_build
from caesar_yolo_tpu_torch.ops.histeq import NBINS, equalize_hist


def equalize_hist_batch(planes: torch.Tensor) -> torch.Tensor:
    """planes [P, H, W] f32 -> equalised f32 [P, H, W] in [0, 1].
    CUDA tensors launch the kernel; CPU tensors take `equalize_hist`."""
    if not planes.is_cuda:
        return equalize_hist(planes)
    if planes.ndim != 3 or planes.dtype != torch.float32:
        raise ValueError(f"hist-eq kernel does not take planes "
                         f"{tuple(planes.shape)} {planes.dtype}")
    p = planes.shape[0]
    planes = planes.contiguous()
    out = torch.empty_like(planes)
    lims = torch.empty((p, 3), dtype=torch.int32, device=planes.device)
    hist = torch.empty((p, NBINS), dtype=torch.int32, device=planes.device)
    fn = cuda_build.load("histeq").cy_equalize_hist
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    equalize_hist_batch.launches += 1
    cuda_build.check(fn(planes.data_ptr(), out.data_ptr(), lims.data_ptr(),
                        hist.data_ptr(), p, planes[0].numel(),
                        cuda_build.stream_ptr(planes.device)),
                     "hist-eq kernel")
    return out


equalize_hist_batch.launches = 0
