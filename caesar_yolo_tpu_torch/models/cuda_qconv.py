"""The int8 convolution of the PTQ path (kernel K9).

The JAX package's int8 branch (caesar_yolo_tpu/models/layers.py:139-149)
quantizes a dense conv's input with its calibrated per-tensor scale xs,
convolves s8 x s8 -> s32 with the per-output-channel int8 weights, and
dequantizes: y = (acc * (ws * xs) + b) in f32, cast to the input's dtype,
then the reference's SiLU (models/cuda_epilogue.py:silu).  XLA compiled it
unaided; PyTorch has no int8 convolution on CUDA, so on a CUDA tensor
`qconv` launches csrc/qconv.cu's two kernels (`quantize_padded`: the input
quantized once into a padded int8 copy; `qgemm`: an implicit GEMM fed by
TMA into wgmma s8, the dequantize, bias and SiLU in its epilogue) and on a
CPU tensor runs `qconv_plain`.  The kernels equal the plain version bit for
bit.

Layouts: x [B, cin, H, W] in any strided layout (the quantize pass reads
it through its strides; the port's activations are channels_last or
channel slices of it); wq int8 [cout, cin, k, k] whose memory is
[cout][k][k][cin] (channels_last, as predictor.prepare_model lays the
quantized model out on the card), which `pack_weights` pads once to
[cout][k][k][Cp] (Cp = cin rounded up to 16; prepare_model keeps it as the
Conv's `wp`); ws and b f32 [cout]; xs f32, one value, on x's device.  The
output is channels_last, in x's dtype.  Under torch.export `qconv` calls
the op caesar_yolo::qconv (utils/portable.py), whose body is the same
dispatch.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from caesar_yolo_tpu_torch import cuda_build
from caesar_yolo_tpu_torch.models.cuda_epilogue import silu
from caesar_yolo_tpu_torch.utils import portable

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the largest |sum| of K products of int8 values in [-127, 127] must stay
# below 2^31 for the kernel's int32 accumulators
MAX_K = (2 ** 31 - 1) // (127 * 127)
# channels a TMA box (bytes of int8) and the rows of K9's M tile
CHUNK = 16
TILE_ROWS = 128


def quantize_input(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """clip(round(x / xs), -127, 127) in f32 (round half to even, as
    jnp.round)."""
    return torch.clamp(torch.round(x.float() / xs), -127, 127)


def qconv_plain(x, wq, ws, xs, b, stride: int, pad: int, act: bool,
                wp=None):
    """The plain version: the integer conv as F.conv2d in f64 (every partial
    sum is an integer below 2^53, so exact on any device; rounded to
    integers again in case the library took an FFT or Winograd path), then
    the dequantize, bias, cast and SiLU as PyTorch ops in the kernel's
    order.  `wp` (qconv's packed weights) is not read: wq is."""
    xq = quantize_input(x, xs)
    acc = torch.round(F.conv2d(xq.double(), wq.double(), None, stride, pad))
    y = (acc.float() * (ws * xs)[:, None, None]
         + b[:, None, None]).to(x.dtype)
    return silu(y) if act else y


def padded_channels(cin: int) -> int:
    """Cp: cin rounded up to a multiple of 16 (TMA's 16-byte boxes)."""
    return -(-cin // CHUNK) * CHUNK


def quantize_padded_plain(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The quantize pass's plain version: int8 [B, H, W, Cp] contiguous,
    quantize_input's values with the channels from cin on 0."""
    cp = padded_channels(x.shape[1])
    xq = quantize_input(x, xs).to(torch.int8).permute(0, 2, 3, 1)
    return F.pad(xq, (0, cp - x.shape[1])).contiguous()


def pack_weights(wq: torch.Tensor) -> torch.Tensor:
    """wq [cout, cin, k, k] -> int8 [cout, k, k, Cp] contiguous, the
    channels from cin on 0 (K9's weight layout)."""
    cp = padded_channels(wq.shape[1])
    return F.pad(wq.permute(0, 2, 3, 1), (0, cp - wq.shape[1])).contiguous()


@functools.cache
def plan(h: int, w: int, cin: int, cout: int, k: int,
         stride: int) -> tuple[int, int, int, int]:
    """K9's GEMM tile for a conv -> (tw, th, kb, bn): a tw x th rectangle
    of output pixels (at most TILE_ROWS, the fewest rectangles an image,
    then the widest), kb channels (bytes of K) a pipeline stage, 32, 64 or
    128 (the fewest padded bytes plus one wgmma's worth a stage), and bn
    output channels (64 up to cout 64, else 128)."""
    pad = k // 2
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    best = None
    for tw in range(1, min(wo, TILE_ROWS) + 1):
        th = min(TILE_ROWS // tw, ho)
        key = (-(-wo // tw) * -(-ho // th), -tw)
        if best is None or key < best[0]:
            best = (key, tw, th)
    cp = padded_channels(cin)
    kb = min((128, 64, 32), key=lambda n: -(-cp // n) * (n + 32))
    return best[1], best[2], kb, 64 if cout <= 64 else 128


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


def qconv(x, wq, ws, xs, b, stride: int, pad: int, act: bool, wp=None):
    """The int8 conv (see the module's docstring): K9 on CUDA, the plain
    version on the CPU.  `wp` is pack_weights(wq) where the caller keeps it
    (packed here otherwise)."""
    if portable.exporting():
        return torch.ops.caesar_yolo.qconv(x, wq, ws, xs, b, int(stride),
                                           int(pad), bool(act), wp)
    if not x.is_cuda:
        return qconv_plain(x, wq, ws, xs, b, stride, pad, act)
    check_shapes(x, wq, ws, xs, b, stride, pad)
    tensors = (wq, ws, xs, b) + (() if wp is None else (wp,))
    if any(t.device != x.device for t in tensors):
        raise ValueError("int8 conv kernel: x, wq, ws, xs and b must lie on "
                         "one device")
    if not (wq.permute(0, 2, 3, 1).is_contiguous() and ws.is_contiguous()
            and b.is_contiguous()):
        raise ValueError("int8 conv kernel takes wq in channels_last memory "
                         "([cout][k][k][cin]) and contiguous ws and b")
    cout, cin, k, _ = wq.shape
    if wp is None:
        wp = pack_weights(wq)
    elif (wp.shape != (cout, k, k, padded_channels(cin))
          or wp.dtype != torch.int8 or not wp.is_contiguous()):
        raise ValueError(f"int8 conv kernel: packed weights {tuple(wp.shape)}"
                         f" {wp.dtype} are not pack_weights(wq)")
    return qgemm(quantize_padded(x, xs), wp, ws, xs, b, stride, pad, act,
                 x.dtype)


cuda_build.counters(qconv, "launches")


@torch.library.custom_op("caesar_yolo::qconv", mutates_args=())
def _qconv_op(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
              xs: torch.Tensor, b: torch.Tensor, stride: int, pad: int,
              act: bool, wp: torch.Tensor | None) -> torch.Tensor:
    return qconv(x, wq, ws, xs, b, stride, pad, act, wp).contiguous(
        memory_format=portable.channels_last_on_cuda(x))


@_qconv_op.register_fake
def _(x, wq, ws, xs, b, stride, pad, act, wp):
    k = wq.shape[2]
    ho = (x.shape[2] + 2 * pad - k) // stride + 1
    wo = (x.shape[3] + 2 * pad - k) // stride + 1
    return torch.empty((x.shape[0], wq.shape[0], ho, wo), dtype=x.dtype,
                       device=x.device,
                       memory_format=portable.channels_last_on_cuda(x))


def quantize_padded(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The quantize pass on a CUDA x (any strides): int8 [B, H, W, Cp]
    equal to quantize_padded_plain(x, xs)."""
    bsz, cin, h, w = x.shape
    cp = padded_channels(cin)
    xq = torch.empty((bsz, h, w, cp), dtype=torch.int8, device=x.device)
    sn, sc, sh, sw = x.stride()
    cuda_build.check(_entry("cy_qconv_quantize")(
        x.data_ptr(), _DTYPE_CODES[x.dtype], bsz, cin, h, w, sn, sc, sh, sw,
        xs.data_ptr(), xq.data_ptr(), cp, cuda_build.stream_ptr(x.device)),
        "int8 conv kernel (quantize)")
    return xq


def qgemm(xq, wp, ws, xs, b, stride: int, pad: int, act: bool,
          dtype: torch.dtype) -> torch.Tensor:
    """The GEMM on the card: xq [B, H, W, Cp] from quantize_padded, wp
    from pack_weights -> y [B, cout, Ho, Wo] channels_last in `dtype`.
    Counted in qconv.launches."""
    bsz, h, w, cp = xq.shape
    cout, k = wp.shape[0], wp.shape[1]
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    tw, th, kb, bn = plan(h, w, cp, cout, k, stride)
    y = torch.empty((bsz, cout, ho, wo), dtype=dtype, device=xq.device,
                    memory_format=torch.channels_last)
    qconv.launches += 1
    cuda_build.check(_entry("cy_qconv_gemm")(
        xq.data_ptr(), _DTYPE_CODES[dtype], bsz, h, w, cp, wp.data_ptr(),
        ws.data_ptr(), xs.data_ptr(), b.data_ptr(), y.data_ptr(), cout, k,
        stride, pad, int(bool(act)), tw, th, kb, bn,
        cuda_build.stream_ptr(xq.device)), "int8 conv kernel")
    return y


_ARGTYPES = {
    "cy_qconv_quantize": ([ctypes.c_void_p] + [ctypes.c_int] * 5
                          + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 2
                          + [ctypes.c_int, ctypes.c_void_p]),
    "cy_qconv_gemm": ([ctypes.c_void_p] + [ctypes.c_int] * 5
                      + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                      + [ctypes.c_void_p]),
}


@functools.cache
def _entry(name: str):
    """A C entry point of csrc/qconv.cu, its argument types set once."""
    fn = getattr(cuda_build.load("qconv"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn
