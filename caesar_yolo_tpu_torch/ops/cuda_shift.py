"""Per-row fractional shift, the shear pass of the augmentation resampler
(kernel K8).

Counterpart of caesar_yolo_tpu/ops/pallas_shift.py.  On a CUDA tensor
`fractional_row_shift_batch` launches the kernel of csrc/shift.cu (one
thread per output element, built with -fmad=false, bit-equal to the plain
version); on a CPU tensor it runs `row_shift_plain`, the dynamic-slice
form of caesar_yolo_tpu/train/augment._row_shift_batch (augment.py:161-176)
written as a gather of each row's window of the padded canvas.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from caesar_yolo_tpu_torch import cuda_build


def _split_shifts(shifts: torch.Tensor, pad: int):
    """Integer part clipped to [-pad, pad - 1] and fraction, as the
    reference (the fraction comes from the unclipped floor)."""
    fl = torch.floor(shifts)
    return fl.to(torch.int32).clamp(-pad, pad - 1), shifts - fl


def row_shift_plain(imgs: torch.Tensor, shifts: torch.Tensor, pad: int,
                    pad_val: float = 0.0) -> torch.Tensor:
    """out[b, y, x] = lerp(img[b, y, x + k], img[b, y, x + k + 1], f) on the
    canvas padded by `pad` pixels of `pad_val` along W."""
    b, h, w, c = imgs.shape
    k0, f = _split_shifts(shifts, pad)
    padded = F.pad(imgs, (0, 0, pad, pad), value=pad_val)
    idx = (torch.arange(w, device=imgs.device)[None, None, :]
           + (k0.long() + pad)[:, :, None])                   # [B, H, W]
    idx = idx[..., None].expand(b, h, w, c)
    a = torch.gather(padded, 2, idx)
    bb = torch.gather(padded, 2, idx + 1)
    f = f[:, :, None, None]
    return a * (1 - f) + bb * f


def fractional_row_shift_batch(imgs: torch.Tensor, shifts: torch.Tensor,
                               pad: int,
                               pad_val: float = 0.0) -> torch.Tensor:
    """out[b, y, x] = imgs[b, y, x + shifts[b, y]] bilinearly.

    imgs [B, H, W, C] f32; shifts [B, H]; out-of-frame samples read
    `pad_val`.  CUDA tensors launch the kernel (and raise on what it does
    not take); CPU tensors take `row_shift_plain`."""
    if not imgs.is_cuda:
        return row_shift_plain(imgs, shifts, pad, pad_val)
    b, h, w, c = imgs.shape
    if imgs.dtype != torch.float32 or shifts.shape != (b, h):
        raise ValueError(f"row shift kernel does not take {tuple(imgs.shape)} "
                         f"{imgs.dtype} with shifts {tuple(shifts.shape)}")
    k0, f = _split_shifts(shifts.float(), pad)
    imgs, k0, f = imgs.contiguous(), k0.contiguous(), f.contiguous()
    out = torch.empty_like(imgs)
    fn = cuda_build.load("shift").cy_row_shift
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fractional_row_shift_batch.launches += 1
    cuda_build.check(fn(imgs.data_ptr(), k0.data_ptr(), f.data_ptr(),
                        out.data_ptr(), b, h, w, c, float(pad_val),
                        cuda_build.stream_ptr(imgs.device)),
                     "row shift kernel")
    return out


fractional_row_shift_batch.launches = 0
