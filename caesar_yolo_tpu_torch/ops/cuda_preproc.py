"""Fused zscale + min-max normalisation (kernel K3).

Counterpart of caesar_yolo_tpu/ops/pallas_preproc.py.  For each plane:
zscale stretch with its (vmin, vmax) from `zscale_limits` (computed
outside the kernel, as in the reference), the masked min/max of the
stretched values, and normalisation to [norm_min, norm_max].  Returns
(out, valid) with valid = isfinite(zmin) & (zmax > zmin), the
reference's predicate (pallas_preproc.py:114).

On a CUDA tensor it launches the hand-written kernel in
csrc/preproc.cu (a reduce launch with exact atomic min/max, then an
apply launch; see the source for its design and bound).  On a CPU tensor
it runs `zscale_minmax_plain`, the same chain in PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from caesar_yolo_tpu_torch import cuda_build
from caesar_yolo_tpu_torch.ops.stats import valid_mask
from caesar_yolo_tpu_torch.ops.zscale import zscale_apply, zscale_limits


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
    zlims [P, 2]).  CUDA tensors launch the kernel; CPU tensors take
    `zscale_minmax_plain`."""
    if not planes.is_cuda:
        return zscale_minmax_plain(planes, vlims, norm_min, norm_max)
    p = planes.shape[0]
    if (planes.ndim != 3 or planes.dtype != torch.float32
            or vlims.shape != (p, 2) or vlims.dtype != torch.float32):
        raise ValueError(f"zscale+minmax kernel does not take planes "
                         f"{tuple(planes.shape)} {planes.dtype}, vlims "
                         f"{tuple(vlims.shape)} {vlims.dtype}")
    planes = planes.contiguous()
    vlims = vlims.contiguous()
    out = torch.empty_like(planes)
    zlims = torch.empty((p, 2), device=planes.device)  # set by the kernel
    fn = cuda_build.load("preproc").cy_zscale_minmax
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_float, ctypes.c_float,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    zscale_minmax.launches += 1
    cuda_build.check(fn(planes.data_ptr(), vlims.data_ptr(), zlims.data_ptr(),
                        out.data_ptr(), p, planes[0].numel(),
                        float(norm_min), float(norm_max),
                        cuda_build.stream_ptr(planes.device)),
                     "zscale+minmax kernel")
    return out, zlims


zscale_minmax.launches = 0


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
