"""Per-row fractional shift, the shear pass of the augmentation resampler
(kernel K8).

Counterpart of caesar_yolo_tpu/ops/pallas_shift.py.  On a CUDA tensor
`fractional_row_shift_batch` launches the kernel of csrc/shift.cu (built
with -fmad=false, bit-equal to the plain version) on the route `route`
picks from the input's strides: the row route for a contiguous canvas
(the x-shear), the column route for the transposed view of one (the
y-shear, which so reads the canvas in place).  On a CPU tensor it runs
`row_shift_plain`, the dynamic-slice form of
caesar_yolo_tpu/train/augment._row_shift_batch (augment.py:161-176)
written as a gather of each row's window of the padded canvas.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from caesar_yolo_tpu_torch import cuda_build

# The column route's tiles (csrc/shift.cu), chosen by measurement on an
# H100 (scripts/torch_kernel_tune.py, PERF.md): strips of COL_X columns,
# bands of COL_Y output rows, about COL_THREADS threads a block.
COL_X = 32
COL_Y = 64
COL_THREADS = 256
# the row route stages two rows of W*C floats in shared memory
MAX_ROW_FLOATS = 28672


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


def route(shape, strides) -> str:
    """The kernel's route for imgs [B, H, W, C] of these strides, shifted
    along W: "row" when each (b, y) row is contiguous and the rows are in
    order (a contiguous canvas), "column" when imgs is the transposed view
    [B, H, W, C] of a contiguous canvas [B, W, H, C] (W is then the
    canvas's row axis).  Dimensions of size 1 take any stride.  Raises
    ValueError on a channel stride that is not 1 or another layout: the
    kernel never copies its input into a layout it takes."""
    b, h, w, c = shape

    def fits(want):
        return all(n == 1 or s == t for n, s, t in zip(shape, strides, want))

    if c > 1 and strides[3] != 1:
        raise ValueError(f"row shift kernel: channel stride {strides[3]} of "
                         f"{tuple(shape)} is not 1")
    if fits((h * w * c, w * c, c, 1)):
        return "row"
    if fits((h * w * c, c, h * c, 1)):
        return "column"
    raise ValueError(f"row shift kernel does not take {tuple(shape)} with "
                     f"strides {tuple(strides)}: neither a contiguous canvas "
                     f"nor the transpose of one")


def col_threads(c: int, xw: int = COL_X, threads: int = COL_THREADS) -> int:
    """The column route's block size: a multiple of a strip row's xw * c
    floats, about `threads`."""
    return xw * c * max(1, threads // (xw * c))


def fractional_row_shift_batch(imgs: torch.Tensor, shifts: torch.Tensor,
                               pad: int,
                               pad_val: float = 0.0) -> torch.Tensor:
    """out[b, y, x] = imgs[b, y, x + shifts[b, y]] bilinearly.

    imgs [B, H, W, C] f32; shifts [B, H]; out-of-frame samples read
    `pad_val`.  The output has the input's strides.  CUDA tensors launch
    the kernel on the route `route` picks (counted in `launches` and in
    `row_launches` or `column_launches`), and raise on what it does not
    take; CPU tensors take `row_shift_plain`."""
    if not imgs.is_cuda:
        return row_shift_plain(imgs, shifts, pad, pad_val)
    b, h, w, c = imgs.shape
    if imgs.dtype != torch.float32 or shifts.shape != (b, h):
        raise ValueError(f"row shift kernel does not take {tuple(imgs.shape)} "
                         f"{imgs.dtype} with shifts {tuple(shifts.shape)}")
    way = route(imgs.shape, imgs.stride())
    if way == "row" and w * c > MAX_ROW_FLOATS:
        raise ValueError(f"row shift kernel: rows of {w * c} floats exceed "
                         f"{MAX_ROW_FLOATS}")
    if way == "column" and COL_X * c > 1024:
        raise ValueError(f"row shift kernel: {c} channels exceed a block")
    k0, f = _split_shifts(shifts.float(), pad)
    return launch(imgs, k0.contiguous(), f.contiguous(), pad_val, way)


def launch(imgs, k0, f, pad_val, way, xw=COL_X, yh=COL_Y,
           threads=COL_THREADS):
    """One launch on CUDA imgs [B, H, W, C] in the layout of `way` with
    split shifts k0 (int32) and f [B, H] (`fractional_row_shift_batch`
    passes its own; the tile arguments are the column route's)."""
    b, h, w, c = imgs.shape
    out = torch.empty_like(imgs)
    stream = cuda_build.stream_ptr(imgs.device)
    lib = _lib()
    fractional_row_shift_batch.launches += 1
    if way == "row":
        fractional_row_shift_batch.row_launches += 1
        code = lib.cy_row_shift(imgs.data_ptr(), k0.data_ptr(), f.data_ptr(),
                                out.data_ptr(), b * h, w * c, c,
                                float(pad_val), stream)
    else:
        fractional_row_shift_batch.column_launches += 1
        code = lib.cy_col_shift(imgs.data_ptr(), k0.data_ptr(), f.data_ptr(),
                                out.data_ptr(), b, w, h, c, xw, yh,
                                col_threads(c, xw, threads), float(pad_val),
                                stream)
    cuda_build.check(code, f"row shift kernel ({way} route)")
    return out


@functools.cache
def _lib():
    """The library, its entry points' argument types set once."""
    lib = cuda_build.load("shift")
    lib.cy_row_shift.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.cy_col_shift.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.cy_row_shift.restype = lib.cy_col_shift.restype = ctypes.c_int
    return lib


cuda_build.counters(fractional_row_shift_batch,
                    "launches", "row_launches", "column_launches")
