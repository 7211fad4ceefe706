"""The int8 convolution of the PTQ path (kernel K9).

The JAX package's int8 branch (caesar_yolo_tpu/models/layers.py:139-149)
quantizes a dense conv's input with its calibrated per-tensor scale xs,
convolves s8 x s8 -> s32 with the per-output-channel int8 weights, and
dequantizes: y = (acc * (ws * xs) + b) in f32, cast to the input's dtype,
then SiLU.  XLA compiled it unaided; PyTorch has no int8 convolution on
CUDA, so on a CUDA tensor `qconv` launches csrc/qconv.cu (an implicit
GEMM on mma.sync s8 with the quantize fused into its loads and the
epilogue into its stores) and on a CPU tensor runs `qconv_plain`.  The
kernel equals the plain version bit for bit.

Layouts: x [B, cin, H, W] in any strided layout (the kernel reads it
through its strides; the port's activations are channels_last or channel
slices of it); wq int8 [cout, cin, k, k] whose memory is [cout][k][k][cin]
(channels_last, as predictor.prepare_model lays the quantized model out on
the card); ws and b f32 [cout]; xs f32, one value, on x's device.  The
output is channels_last, in x's dtype.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from caesar_yolo_tpu_torch import cuda_build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the largest |sum| of K products of int8 values in [-127, 127] must stay
# below 2^31 for the kernel's int32 accumulators
MAX_K = (2 ** 31 - 1) // (127 * 127)


def quantize_input(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """clip(round(x / xs), -127, 127) in f32 (round half to even, as
    jnp.round)."""
    return torch.clamp(torch.round(x.float() / xs), -127, 127)


def qconv_plain(x, wq, ws, xs, b, stride: int, pad: int, act: bool):
    """The plain version: the integer conv as F.conv2d in f64 (every partial
    sum is an integer below 2^53, so exact on any device; rounded to
    integers again in case the library took an FFT or Winograd path), then
    the dequantize, bias, cast and SiLU as PyTorch ops in the kernel's
    order."""
    xq = quantize_input(x, xs)
    acc = torch.round(F.conv2d(xq.double(), wq.double(), None, stride, pad))
    y = (acc.float() * (ws * xs)[:, None, None]
         + b[:, None, None]).to(x.dtype)
    return F.silu(y) if act else y


def check_shapes(x, wq, ws, xs, b, stride: int, pad: int) -> None:
    """Raise ValueError for what K9 does not take."""
    cout, cin, kh, kw = wq.shape
    ok = (x.dim() == 4 and x.shape[1] == cin and x.dtype in _DTYPE_CODES
          and wq.dtype == torch.int8 and kh == kw and kh in (1, 3)
          and stride in (1, 2) and pad == kh // 2
          and kh * kw * cin <= MAX_K
          and ws.shape == (cout,) and b.shape == (cout,)
          and ws.dtype == b.dtype == xs.dtype == torch.float32
          and xs.numel() == 1 and x.shape[2] > 0 and x.shape[3] > 0)
    if not ok:
        raise ValueError(
            f"int8 conv kernel does not take x {tuple(x.shape)} {x.dtype}, "
            f"wq {tuple(wq.shape)} {wq.dtype}, stride {stride}, pad {pad}")


def qconv(x, wq, ws, xs, b, stride: int, pad: int, act: bool):
    """The int8 conv (see the module's docstring): K9 on CUDA, the plain
    version on the CPU."""
    if not x.is_cuda:
        return qconv_plain(x, wq, ws, xs, b, stride, pad, act)
    check_shapes(x, wq, ws, xs, b, stride, pad)
    tensors = (wq, ws, xs, b)
    if any(t.device != x.device for t in tensors):
        raise ValueError("int8 conv kernel: x, wq, ws, xs and b must lie on "
                         "one device")
    if not (wq.permute(0, 2, 3, 1).is_contiguous() and ws.is_contiguous()
            and b.is_contiguous()):
        raise ValueError("int8 conv kernel takes wq in channels_last memory "
                         "([cout][k][k][cin]) and contiguous ws and b")
    bsz, cin, h, w = x.shape
    cout, _, k, _ = wq.shape
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    y = torch.empty((bsz, cout, ho, wo), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    sn, sc, sh, sw = x.stride()
    qconv.launches += 1
    cuda_build.check(_entry()(
        x.data_ptr(), _DTYPE_CODES[x.dtype], bsz, cin, h, w, sn, sc, sh, sw,
        wq.data_ptr(), ws.data_ptr(), xs.data_ptr(), b.data_ptr(),
        y.data_ptr(), cout, k, stride, pad, int(bool(act)),
        cuda_build.stream_ptr(x.device)), "int8 conv kernel")
    return y


qconv.launches = 0


@functools.cache
def _entry():
    """The C entry point, its argument types set once."""
    fn = cuda_build.load("qconv").cy_qconv
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn
