"""The bf16 conv epilogue of inference (kernel K10) and the reference's SiLU.

The JAX package's inference conv (caesar_yolo_tpu/models/layers.py:159-
184, Conv2dRaw :213-216) emits f32 from bf16 operands, adds its f32 bias
(or applies BN's `y * scale + shift` in f32), casts once to bf16, then
applies `silu(x) = x * jax.nn.sigmoid(x)` (:92-93), which on bf16 rounds
each of its four ops to bf16: `y * (1 / (1 + exp(-y)))`.  F.silu rounds
once, and so differs from it (on 3.7% of the bf16 values in [-12, 12],
tests/test_torch_epilogue.py).

`conv_epilogue(y, scale, shift, act)` takes the conv's f32 output
[B, C, H, W] and returns bf16: `y * scale + shift` in f32 (`scale`
optional), rounded once, then `silu` if `act`.  On a CUDA tensor it
launches csrc/epilogue.cu (channels_last in and out, 16-byte stores),
bit-equal to `epilogue_plain`, which the CPU runs.  K9's epilogue
(csrc/qconv.cu) takes its SiLU from the same csrc/epilogue.cuh.  Under
torch.export `conv_epilogue` calls the op caesar_yolo::conv_epilogue
(utils/portable.py), whose body is the same dispatch.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from caesar_yolo_tpu_torch import cuda_build
from caesar_yolo_tpu_torch.utils import portable


def silu(y: torch.Tensor) -> torch.Tensor:
    """The reference's SiLU: in bf16 `y * (1 / (1 + exp(-y)))` with every
    op rounded to bf16 (as XLA evaluates jax.nn.sigmoid's form); in f32
    F.silu, which agrees with that form to f32 rounding."""
    if y.dtype == torch.bfloat16:
        return y * (1 / (1 + torch.exp(-y)))
    return F.silu(y)


def epilogue_plain(y: torch.Tensor, scale: torch.Tensor | None,
                   shift: torch.Tensor, act: bool) -> torch.Tensor:
    """The plain version: y [B, C, H, W] f32 times scale [C] (if given),
    plus shift [C], each op in f32; one rounding to bf16; then `silu`."""
    if scale is not None:
        y = y * scale[:, None, None]
    y = (y + shift[:, None, None]).to(torch.bfloat16)
    return silu(y) if act else y


def check_inputs(y, scale, shift) -> None:
    """Raise ValueError for what K10 does not take."""
    c = y.shape[1] if y.dim() == 4 else -1
    ok = (y.dim() == 4 and y.dtype == torch.float32
          and shift.shape == (c,) and shift.dtype == torch.float32
          and (scale is None or (scale.shape == (c,)
                                 and scale.dtype == torch.float32)))
    if not ok:
        raise ValueError(
            f"conv epilogue kernel does not take y {tuple(y.shape)} "
            f"{y.dtype}, shift {tuple(shift.shape)} {shift.dtype}, scale "
            f"{None if scale is None else (tuple(scale.shape), scale.dtype)}")


def conv_epilogue(y: torch.Tensor, scale: torch.Tensor | None,
                  shift: torch.Tensor, act: bool) -> torch.Tensor:
    """The epilogue (see the module's docstring): K10 on CUDA, the plain
    version on the CPU.  On CUDA the output is channels_last bf16; an f32
    input in another layout is made channels_last first."""
    if portable.exporting():
        return torch.ops.caesar_yolo.conv_epilogue(y, scale, shift,
                                                   bool(act))
    if not y.is_cuda:
        return epilogue_plain(y, scale, shift, act)
    check_inputs(y, scale, shift)
    vecs = [shift] + ([] if scale is None else [scale])
    if any(t.device != y.device for t in vecs):
        raise ValueError("conv epilogue kernel: y, scale and shift must lie "
                         "on one device")
    y = y.contiguous(memory_format=torch.channels_last)
    shift = shift.contiguous()
    scale = None if scale is None else scale.contiguous()
    b, c, h, w = y.shape
    out = torch.empty((b, c, h, w), dtype=torch.bfloat16, device=y.device,
                      memory_format=torch.channels_last)
    conv_epilogue.launches += 1
    cuda_build.check(_entry()(
        y.data_ptr(), None if scale is None else scale.data_ptr(),
        shift.data_ptr(), out.data_ptr(), y.numel(), c, int(bool(act)),
        cuda_build.stream_ptr(y.device)), "conv epilogue kernel")
    return out


cuda_build.counters(conv_epilogue, "launches")


@torch.library.custom_op("caesar_yolo::conv_epilogue", mutates_args=())
def _conv_epilogue_op(y: torch.Tensor, scale: torch.Tensor | None,
                      shift: torch.Tensor, act: bool) -> torch.Tensor:
    return conv_epilogue(y, scale, shift, act).contiguous(
        memory_format=portable.channels_last_on_cuda(y))


@_conv_epilogue_op.register_fake
def _(y, scale, shift, act):
    return torch.empty(y.shape, dtype=torch.bfloat16, device=y.device,
                       memory_format=portable.channels_last_on_cuda(y))


@functools.cache
def _entry():
    """The C entry point, its argument types set once."""
    fn = cuda_build.load("epilogue").cy_conv_epilogue
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
