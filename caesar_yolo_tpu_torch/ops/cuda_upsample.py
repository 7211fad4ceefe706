"""2x nearest-neighbour upsample and its gradient (kernel K4).

Counterpart of caesar_yolo_tpu/ops/pallas_upsample.py.  The JAX package
made its kernel opt-in (models/layers.py CY_UPSAMPLE) and had no gradient
for it; every mode is exact pixel replication, so the port takes the
kernel on the card in serving and in training, and its gradient too.

`upsample2x(x[B, C, H, W])` is differentiable.  On a CUDA tensor the
forward and the backward launch the kernels of csrc/upsample.cu, which
return channels_last memory (the port's layout on the card); the
backward reads any gradient whose channels are contiguous where it lies
(in the YOLO neck, a channel slice of the concat's channels_last
gradient), in vectors of the width `backward_plan` picks.  On a CPU
tensor they run `upsample2x_plain` (the reference's broadcast form,
layers.py:475-477) and `upsample2x_backward_plain`.  Under torch.export
the forward calls the op caesar_yolo::upsample2x (utils/portable.py),
whose body is the same dispatch; export traces no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from caesar_yolo_tpu_torch import cuda_build
from caesar_yolo_tpu_torch.utils import portable

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def upsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, 2H, 2W] by broadcast and reshape."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(
        b, c, 2 * h, 2 * w)


def upsample2x_backward_plain(g: torch.Tensor) -> torch.Tensor:
    """[B, C, 2H, 2W] -> [B, C, H, W]: each 2x2 window summed in f32 as
    ((g00 + g01) + g10) + g11, rounded once to g's dtype."""
    b, c, h2, w2 = g.shape
    gf = g.float().reshape(b, c, h2 // 2, 2, w2 // 2, 2)
    s = (gf[:, :, :, 0, :, 0] + gf[:, :, :, 0, :, 1]
         + gf[:, :, :, 1, :, 0] + gf[:, :, :, 1, :, 1])
    return s.to(g.dtype)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def upsample2x_forward(x: torch.Tensor) -> torch.Tensor:
    """The forward alone: the kernel on CUDA, the plain form on the CPU."""
    if portable.exporting():
        return torch.ops.caesar_yolo.upsample2x(x)
    if not x.is_cuda:
        return upsample2x_plain(x)
    b, c, h, w = x.shape
    pixel_bytes = c * x.element_size()
    if pixel_bytes % 2:
        raise ValueError(f"upsample kernel does not take {tuple(x.shape)} "
                         f"{x.dtype}")
    x = _channels_last(x)
    y = torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    fn = cuda_build.load("upsample").cy_upsample2x_fwd
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    upsample2x_forward.launches += 1
    cuda_build.check(fn(x.data_ptr(), y.data_ptr(), b, h, w, pixel_bytes,
                        cuda_build.stream_ptr(x.device)), "upsample kernel")
    return y


cuda_build.counters(upsample2x_forward, "launches")


@torch.library.custom_op("caesar_yolo::upsample2x", mutates_args=())
def _upsample2x_op(x: torch.Tensor) -> torch.Tensor:
    return upsample2x_forward(x).contiguous(
        memory_format=portable.channels_last_on_cuda(x))


@_upsample2x_op.register_fake
def _(x):
    b, c, h, w = x.shape
    return torch.empty((b, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device,
                       memory_format=portable.channels_last_on_cuda(x))


def backward_plan(shape, strides, offset: int, itemsize: int) -> int:
    """Bytes of each vector K4's backward moves on a gradient of `shape`
    [B, C, 2H, 2W] with element `strides` (channel stride 1) and data
    offset `offset` elements: the widest of 16, 8, 4 and 2 bytes (not
    below the element) that divides C's bytes, the offset's and the batch,
    row and pixel strides' bytes."""
    _, c, _, _ = shape
    if c > 1 and strides[1] != 1:
        raise ValueError(f"upsample backward kernel reads channels with "
                         f"stride 1, not {strides[1]}")
    terms = (c, offset, strides[0], strides[2], strides[3])
    return next(vb for vb in (16, 8, 4, 2, itemsize)
                if vb >= itemsize and all(t * itemsize % vb == 0
                                          for t in terms))


def upsample2x_backward(g: torch.Tensor) -> torch.Tensor:
    """The gradient alone: the kernel on CUDA, the plain form on the CPU.
    A CUDA gradient whose channels are contiguous is read where it lies;
    any other is made channels_last first (counted in
    `upsample2x_backward.copies`)."""
    if not g.is_cuda:
        return upsample2x_backward_plain(g)
    _, c, h2, w2 = g.shape
    if h2 % 2 or w2 % 2 or g.dtype not in _DTYPE_CODES:
        raise ValueError(f"upsample backward kernel does not take "
                         f"{tuple(g.shape)} {g.dtype}")
    if c > 1 and g.stride(1) != 1:
        g = _channels_last(g)
        upsample2x_backward.copies += 1
    return launch_backward(g, backward_plan(g.shape, g.stride(),
                                            g.storage_offset(),
                                            g.element_size()))


def launch_backward(g, vec_bytes):
    """One launch of the backward kernel on a CUDA gradient g [B, C, 2H, 2W]
    with channel stride 1, moving vectors of vec_bytes (`upsample2x_backward`
    passes `backward_plan`'s)."""
    b, c, h2, w2 = g.shape
    gx = torch.empty((b, c, h2 // 2, w2 // 2), dtype=g.dtype,
                     device=g.device, memory_format=torch.channels_last)
    upsample2x_backward.launches += 1
    cuda_build.check(_bwd_entry()(
        g.data_ptr(), gx.data_ptr(), b, h2 // 2, w2 // 2, c, g.stride(0),
        g.stride(2), g.stride(3), _DTYPE_CODES[g.dtype], vec_bytes,
        cuda_build.stream_ptr(g.device)), "upsample backward kernel")
    return gx


@functools.cache
def _bwd_entry():
    """The backward's C entry point, its argument types set once."""
    fn = cuda_build.load("upsample").cy_upsample2x_bwd
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


cuda_build.counters(upsample2x_backward, "launches", "copies")


class _Upsample2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return upsample2x_forward(x)

    @staticmethod
    def backward(ctx, g):
        return upsample2x_backward(g)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Differentiable 2x nearest upsample of [B, C, H, W]."""
    return _Upsample2x.apply(x)
