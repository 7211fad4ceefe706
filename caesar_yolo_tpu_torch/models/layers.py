"""YOLO building blocks as nn.Modules (inference and training).

Counterpart of caesar_yolo_tpu/models/layers.py.  Activations are NCHW
(the caller may hand them over in channels_last memory) and conv weights
OIHW.  Every module's parameter names follow the reference's params
pytree (`w`, `bn/gamma`, `m/0/cv1/w`, ...), so that the reference's npz
weights load by a mechanical walk (models/convert.py).

Conventions kept from the reference: symmetric padding k // 2,
BatchNorm eps 1e-3 folded in f32 (`Conv.fuse`), SPPF max-pooling padded
with -inf, and C2PSA attention with f32 scores and probabilities cast to
the compute dtype before the PV product (models/cuda_attn.py).  YOLO12's
area attention (`AAttn`, `ABlock`, `A2C2f`) has no counterpart in the
reference; it follows ultralytics' modules with the same attention
arithmetic and the same kernel.

Inference follows the reference's arithmetic (`conv_bias_act`): the conv
of the compute-dtype operands with an f32 output, the f32 bias or BN's
`y * scale + shift` in f32, one rounding to the compute dtype, then the
reference's `silu`, which in bf16 rounds each of its four ops
(models/cuda_epilogue.py; on the card the bf16 epilogue is kernel K10).

Inside `train_mode(model)` the convs follow the reference's train mode
(layers.py:154-185, 211-216): the f32 master weight is cast to the
input's dtype on each call, BatchNorm normalises with the current
batch's f32 mean and biased variance over N, H, W (optionally recording
them for precise-BN), and in bf16 the conv output is bf16 while BN's
`y * scale + shift` runs in f32 and is cast back.  Training keeps
F.silu: the reference's four-op form would keep four more tensors for
autograd in bf16, and training is held by distance ratios.  Under a
process group (parallel/mesh.py) BatchNorm normalises with the global
batch's statistics, as the reference's mean and variance over its sharded
global array (layers.py:173-174): `global_moments`, one allgather a layer
in each direction.

int8 PTQ (models/quant.py): inside `quant_calibrate(model)` every Conv
records the running max|x| of its inputs; `Conv.to_int8` turns a fused
Conv into the reference's quantized layer (layers.py:139-149), whose
forward is the int8 conv of models/cuda_qconv.py (kernel K9 on CUDA).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from caesar_yolo_tpu_torch import cuda_build
from caesar_yolo_tpu_torch.models import cuda_attn, cuda_epilogue, cuda_qconv
from caesar_yolo_tpu_torch.models.cuda_epilogue import silu
from caesar_yolo_tpu_torch.ops import cuda_upsample
from caesar_yolo_tpu_torch.parallel import mesh

BN_EPS = 1e-3


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


def conv_f32(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int,
             groups: int = 1) -> torch.Tensor:
    """The conv of x's and w's values with an f32 output, as the
    reference's inference conv (preferred_element_type f32, layers.py:95-
    105).  On the card a bf16 1x1 conv is cuBLAS's bf16 product with an f32
    output (products exact, f32 sums) on the channels_last input as it
    lies; any other is cuDNN's conv of f32 copies of the operands.  bf16
    values are exact in TF32 (8 significant bits against 11), so cuDNN may
    take TF32 there whatever `torch.backends.cudnn.allow_tf32` says: the
    products are exact and summed in f32 either way."""
    if x.dtype != torch.bfloat16 or not x.is_cuda:
        return F.conv2d(x.float(), w.float(), None, stride, pad, 1, groups)
    if w.shape[2:] == (1, 1) and stride == 1 and groups == 1:
        b, c, h, ww = x.shape
        a = x.permute(0, 2, 3, 1).reshape(-1, c)
        y = torch.mm(a, w.reshape(w.shape[0], c).t(),
                     out_dtype=torch.float32)
        return y.view(b, h, ww, -1).permute(0, 3, 1, 2)
    xf, wf = x.float(), w.float()
    if torch.backends.cudnn.allow_tf32:
        return F.conv2d(xf, wf, None, stride, pad, 1, groups)
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    benchmark=torch.backends.cudnn.benchmark,
                                    deterministic=torch.backends.cudnn
                                    .deterministic, allow_tf32=True):
        return F.conv2d(xf, wf, None, stride, pad, 1, groups)


def conv_bias_act(x: torch.Tensor, w: torch.Tensor,
                  scale: torch.Tensor | None, shift: torch.Tensor,
                  stride: int, pad: int, groups: int, act: bool):
    """The reference's inference conv block (layers.py:159-185, 213-216):
    the conv in f32, `y * scale + shift` in f32 (scale: BN's, unfused;
    None for a fused conv's or Conv2dRaw's f32 bias), one rounding to x's
    dtype, then the reference's `silu` if `act`.  In bf16 the epilogue is
    kernel K10 on the card (models/cuda_epilogue.py)."""
    if x.dtype == torch.bfloat16:
        return cuda_epilogue.conv_epilogue(
            conv_f32(x, w, stride, pad, groups), scale, shift, act)
    y = F.conv2d(x, w, None, stride, pad, 1, groups)
    if scale is not None:
        y = y.float() * scale[:, None, None]
    y = y.add_(shift[:, None, None]).to(x.dtype)
    return silu(y) if act else y


def cast_weights(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Conv weights to the compute dtype, in place; biases and BN
    statistics stay f32, as the reference casts only `w` (an int8 Conv has
    none)."""
    for m in module.modules():
        if isinstance(m, (Conv, Conv2dRaw)) and m.w is not None:
            m.w.data = m.w.data.to(dtype)
    return module


def pack_int8(module: nn.Module) -> nn.Module:
    """Lay each int8 Conv's weights out once as K9 reads them
    (cuda_qconv.pack_weights, on the weights' device), in place."""
    for m in module.modules():
        if isinstance(m, Conv) and m.wq is not None:
            m.wp = cuda_qconv.pack_weights(m.wq)
    return module


class train_mode:
    """Context manager: the Conv and Conv2dRaw layers of `module` run in
    the reference's train mode while it is open.  Pass a dict as
    `collect` to also record {BatchNorm module: (mean, var)} of each
    forward's batch statistics (detached; a recompute under remat writes
    the same entry again, so nothing is counted twice).  Keep the
    backward pass inside the context when the forward was rematerialised:
    its recompute reads the same flags."""

    def __init__(self, module: nn.Module, collect: dict | None = None):
        self.convs = [m for m in module.modules()
                      if isinstance(m, (Conv, Conv2dRaw))]
        self.collect = collect

    def __enter__(self):
        for m in self.convs:
            m.train_mode, m.bn_collect = True, self.collect
        return self.collect

    def __exit__(self, *exc):
        for m in self.convs:
            m.train_mode, m.bn_collect = False, None
        return False


class quant_calibrate:
    """Context manager: while it is open, every Conv of `module` (in
    inference mode, not yet int8) records the running max|x| of its input
    in f32 into the returned dict, keyed by the Conv module (the
    reference's quant_calibrate, keyed by id(module))."""

    def __init__(self, module: nn.Module, collect: dict | None = None):
        self.convs = [m for m in module.modules() if isinstance(m, Conv)]
        self.collect = {} if collect is None else collect

    def __enter__(self):
        for m in self.convs:
            m.calib = self.collect
        return self.collect

    def __exit__(self, *exc):
        for m in self.convs:
            m.calib = None
        return False


class _AllGather(torch.autograd.Function):
    """Every rank's tensor stacked [ranks, ...]; the backward sums the
    ranks' gradients of the stack and returns this rank's row."""

    @staticmethod
    def forward(ctx, t):
        return torch.stack(mesh.all_gather(t))

    @staticmethod
    def backward(ctx, grad):
        return mesh.all_reduce_sum(grad.contiguous())[mesh.process_index()]


def global_moments(mean: torch.Tensor, var: torch.Tensor, count: int):
    """The global batch's per-channel (mean, biased variance) in f32 from
    this rank's over `count` values a channel: every rank's (count, mean,
    M2 = var * count) gathered and combined by Chan et al.'s pairwise
    formula, summed over the ranks at once, in f64 and rounded once.
    Differentiable: the gradient reaches every rank's own statistics."""
    stats = torch.stack([torch.full_like(mean, count), mean,
                         var * count]).double()
    n, mu, m2 = _AllGather.apply(stats).unbind(1)
    total = n.sum(0)
    gmean = (n * mu).sum(0) / total
    gm2 = (m2 + n * (mu - gmean) ** 2).sum(0)
    return gmean.float(), (gm2 / total).float()


class BatchNorm(nn.Module):
    """Inference BatchNorm statistics, named as the reference's `bn` dict."""

    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def scale_shift(self):
        """(scale, shift) in f32 with y * scale + shift == BN(y)."""
        return bn_scale_shift(self.gamma, self.beta, self.mean, self.var)


def bn_scale_shift(gamma, beta, mean, var):
    """BatchNorm's (scale, shift) in f32 from its statistics, elementwise:
    y * scale + shift == BN(y).  The one fold arithmetic of inference:
    `BatchNorm.scale_shift`, and models/convert.py:build_prepared on the
    statistics of every conv at once."""
    scale = gamma.float() / torch.sqrt(var.float() + BN_EPS)
    return scale, beta.float() - mean.float() * scale


def fold_bn_weight(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Conv weights `w` [O, I, kh, kw] times BN's per-output-channel
    `scale`, in f32 (`Conv.fuse`, models/convert.py:build_prepared)."""
    return w.float() * scale[:, None, None, None]


class Conv(nn.Module):
    """Conv2d + BatchNorm + SiLU (ultralytics Conv block).

    In inference the conv output stays f32 through BN's epilogue (unfused)
    or the f32 bias (fused) and is cast to the input dtype once
    afterwards, as in the reference (`conv_bias_act`); `fuse()` folds BN
    into `w` and an f32 bias `b` (in f32, before any cast of the weights).
    `to_int8` makes a fused Conv the reference's int8 layer: `w` gives way
    to `wq` (int8, OIHW), `ws` (f32 [cout]) and `xs` (f32, one value),
    named as the reference's quantized params."""

    def __init__(self, cin: int, cout: int, k: int = 1, s: int = 1,
                 groups: int = 1, act: bool = True):
        super().__init__()
        self.cin, self.cout, self.k, self.s = cin, cout, k, s
        self.groups, self.act = groups, act
        self.pad = k // 2
        self.w = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bn = BatchNorm(cout)
        self.b = None
        self.register_buffer("wq", None)
        self.register_buffer("ws", None)
        self.register_buffer("xs", None)
        self.wp = None                 # K9's packed wq (pack_int8)
        self.train_mode = False
        self.bn_collect = None
        self.calib = None

    def forward(self, x):
        if self.train_mode:
            return self._train_forward(x)
        if self.wq is not None:
            return cuda_qconv.qconv(x, self.wq, self.ws, self.xs, self.b,
                                    self.s, self.pad, self.act, self.wp)
        if self.calib is not None:
            amax = float(x.float().abs().amax())
            self.calib[self] = max(self.calib.get(self, 0.0), amax)
        scale, shift = (self.bn.scale_shift() if self.bn is not None
                        else (None, self.b))
        return conv_bias_act(x, self.w, scale, shift, self.s, self.pad,
                             self.groups, self.act)

    def _train_forward(self, x):
        y = F.conv2d(x, self.w.to(x.dtype), None, self.s, self.pad, 1,
                     self.groups)
        if self.bn is not None:
            yf = y.float()
            var, mean = torch.var_mean(yf, dim=(0, 2, 3), correction=0)
            if mesh.distributed():
                mean, var = global_moments(mean, var,
                                           yf.numel() // yf.shape[1])
            if self.bn_collect is not None:
                self.bn_collect[self.bn] = (mean.detach(), var.detach())
            scale = self.bn.gamma / torch.sqrt(var + BN_EPS)
            shift = self.bn.beta - mean * scale
            y = yf * scale[:, None, None] + shift[:, None, None]
        elif self.b is not None:
            y = y.float() + self.b[:, None, None]
        y = y.to(x.dtype)
        return F.silu(y) if self.act else y

    @torch.no_grad()
    def fuse(self):
        """Fold BN into conv weight + bias (inference fast path)."""
        if self.bn is None:
            return
        scale, shift = self.bn.scale_shift()
        self.set_fused(fold_bn_weight(self.w, scale).to(self.w.dtype), shift)

    def set_fused(self, w: torch.Tensor, b: torch.Tensor) -> None:
        """Become a fused Conv with kernel `w` and f32 bias `b` (BatchNorm
        gone), as `fuse` leaves it."""
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)
        self.bn = None

    @torch.no_grad()
    def to_int8(self, wq: torch.Tensor, ws: torch.Tensor,
                xs: torch.Tensor) -> None:
        """Make this fused Conv an int8 one with the given int8 weights
        (OIHW), per-output-channel weight scales and input scale."""
        if self.bn is not None or self.b is None:
            raise ValueError("to_int8 takes a fused Conv (fuse() first)")
        self.w = None
        self.wp = None
        self.wq = wq.to(torch.int8)
        self.ws = ws.float()
        self.xs = xs.float().reshape(())


class Conv2dRaw(nn.Module):
    """Bare Conv2d with bias (detect-head final 1x1s)."""

    def __init__(self, cin: int, cout: int, k: int = 1):
        super().__init__()
        self.cin, self.cout, self.k = cin, cout, k
        self.pad = k // 2
        self.w = nn.Parameter(torch.empty(cout, cin, k, k))
        self.b = nn.Parameter(torch.empty(cout))
        self.train_mode = False
        self.bn_collect = None

    def forward(self, x):
        if self.train_mode:
            # the bias is cast to the conv output's dtype before the add
            # (the reference's train mode; inference keeps it f32)
            y = F.conv2d(x, self.w.to(x.dtype), None, 1, self.pad)
            return (y + self.b.to(y.dtype)[:, None, None]).to(x.dtype)
        return conv_bias_act(x, self.w, None, self.b, 1, self.pad, 1,
                             False)


class Bottleneck(nn.Module):
    """Two convs with optional residual (ultralytics Bottleneck)."""

    def __init__(self, cin: int, cout: int, shortcut: bool = True,
                 groups: int = 1, k: tuple = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(cout * e)
        self.cv1 = Conv(cin, c_, k[0], 1)
        self.cv2 = Conv(c_, cout, k[1], 1, groups=groups)
        self.add = shortcut and cin == cout

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """Cross-stage partial block with n bottlenecks (YOLOv8 C2f)."""

    def __init__(self, cin: int, cout: int, n: int = 1,
                 shortcut: bool = False, groups: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(cout * e)
        self.cv1 = Conv(cin, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, cout, 1, 1)
        self.m = nn.ModuleList(
            Bottleneck(self.c, self.c, shortcut, groups, k=(3, 3), e=1.0)
            for _ in range(n))

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, :self.c], y[:, self.c:]]
        for block in self.m:
            parts.append(block(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class C3(nn.Module):
    """CSP bottleneck with 3 convs (basis of YOLO11's C3k)."""

    def __init__(self, cin: int, cout: int, n: int = 1,
                 shortcut: bool = True, groups: int = 1, e: float = 0.5,
                 k: int = 3):
        super().__init__()
        c_ = int(cout * e)
        self.cv1 = Conv(cin, c_, 1, 1)
        self.cv2 = Conv(cin, c_, 1, 1)
        self.cv3 = Conv(2 * c_, cout, 1, 1)
        self.m = nn.ModuleList(
            Bottleneck(c_, c_, shortcut, groups, k=(k, k), e=1.0)
            for _ in range(n))

    def forward(self, x):
        y1 = self.cv1(x)
        for block in self.m:
            y1 = block(y1)
        return self.cv3(torch.cat([y1, self.cv2(x)], dim=1))


class C3k2(C2f):
    """YOLO11 C3k2: C2f whose inner modules are C3k blocks or Bottlenecks."""

    def __init__(self, cin: int, cout: int, n: int = 1, c3k: bool = False,
                 e: float = 0.5, groups: int = 1, shortcut: bool = True):
        super().__init__(cin, cout, n, shortcut, groups, e)
        if c3k:
            self.m = nn.ModuleList(
                C3(self.c, self.c, 2, shortcut, groups, e=0.5, k=3)
                for _ in range(n))
        else:
            self.m = nn.ModuleList(
                Bottleneck(self.c, self.c, shortcut, groups, e=0.5)
                for _ in range(n))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5x5 max-pools; the pools
    pad with -inf, as the reference's reduce_window."""

    def __init__(self, cin: int, cout: int, k: int = 5):
        super().__init__()
        c_ = cin // 2
        self.k = k
        self.cv1 = Conv(cin, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, cout, 1, 1)

    def forward(self, x):
        y = self.cv1(x)
        p1 = F.max_pool2d(y, self.k, 1, self.k // 2)
        p2 = F.max_pool2d(p1, self.k, 1, self.k // 2)
        p3 = F.max_pool2d(p2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([y, p1, p2, p3], dim=1))


class Attention(nn.Module):
    """Multi-head attention over spatial positions with a depthwise
    positional encoding (YOLO11 PSA attention)."""

    def __init__(self, dim: int, num_heads: int = 8,
                 attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        self.dim = dim
        nh_kd = self.key_dim * num_heads
        self.qkv = Conv(dim, dim + nh_kd * 2, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, groups=dim, act=False)

    def forward(self, x):
        b, _, hh, ww = x.shape
        n = hh * ww
        kd, hd = self.key_dim, self.head_dim
        # the reference's NHWC reshape(b, n, heads, 2*kd + hd) groups the
        # qkv channels per head; in NCHW that is [b, heads, 2*kd + hd, n]
        qkv = self.qkv(x).reshape(b, self.num_heads, 2 * kd + hd, n)
        q = qkv[:, :, :kd].transpose(2, 3)
        k = qkv[:, :, kd:2 * kd].transpose(2, 3)
        v = qkv[:, :, 2 * kd:]                          # [b, heads, hd, n]
        if cuda_attn.fused_gate(n):
            # on CUDA the kernels (forward and backward), which raise for
            # head widths they lack
            out = cuda_attn.fused_attention(q, k, v.transpose(2, 3),
                                            self.scale)
        else:
            # the reference's einsum branch for other sequence lengths
            # (layers.py:377-385): same arithmetic, plain PyTorch
            out = cuda_attn.attention_plain(q, k, v.transpose(2, 3),
                                            self.scale)
        out = out.transpose(2, 3).reshape(b, self.dim, hh, ww)
        out = out + self.pe(v.reshape(b, self.dim, hh, ww))
        return self.proj(out)


class PSABlock(nn.Module):
    """Attention + a small conv FFN, both residual (YOLO11)."""

    def __init__(self, c: int, attn_ratio: float = 0.5, num_heads: int = 4):
        super().__init__()
        self.attn = Attention(c, num_heads=num_heads, attn_ratio=attn_ratio)
        self.ffn1 = Conv(c, c * 2, 1)
        self.ffn2 = Conv(c * 2, c, 1, act=False)

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn2(self.ffn1(x))


class C2PSA(nn.Module):
    """Partial self-attention stage after SPPF (YOLO11)."""

    def __init__(self, cin: int, cout: int, n: int = 1, e: float = 0.5):
        super().__init__()
        if cin != cout:
            raise ValueError("C2PSA needs cin == cout")
        self.c = int(cin * e)
        self.cv1 = Conv(cin, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, cin, 1, 1)
        self.m = nn.ModuleList(
            PSABlock(self.c, attn_ratio=0.5, num_heads=max(1, self.c // 64))
            for _ in range(n))

    def forward(self, x):
        y = self.cv1(x)
        a, b = y[:, :self.c], y[:, self.c:]
        for block in self.m:
            b = block(b)
        return self.cv2(torch.cat([a, b], dim=1))


AREA_ATTN_FUSED = "model.area_attn_fused"
AREA_ATTN_PLAIN = "model.area_attn_plain"


def area_attention(q, k, v, scale: float):
    """q, k, v [B, H, N, hd] -> [B, H, N, hd]: K2 (`fused_attention`,
    forward and backward) where the reference's gate takes N, else
    `attention_plain`, as `Attention` dispatches.  Counts each call in
    `area_attention.fused` (K2 launched on CUDA) or `.plain` (any other
    path, the CPU's included); both are launch counters of
    cuda_build.COUNTERS, so a replayed CUDA graph advances them."""
    gate = cuda_attn.fused_gate(q.shape[2])
    if gate and q.is_cuda:
        area_attention.fused += 1
    else:
        area_attention.plain += 1
    if gate:
        return cuda_attn.fused_attention(q, k, v, scale)
    return cuda_attn.attention_plain(q, k, v, scale)


cuda_build.counters(area_attention, "fused", "plain")


def area_attn_counts() -> dict[str, int]:
    """The area-attention counters by their report names."""
    return {AREA_ATTN_FUSED: area_attention.fused,
            AREA_ATTN_PLAIN: area_attention.plain}


class AAttn(nn.Module):
    """Area attention (YOLO12): heads of `dim // num_heads` channels over
    the positions of `area` horizontal strips, each strip on its own.

    qkv is a 1x1 conv to 3 * dim channels read row-major as [B, N, 3 * dim]
    (NHWC), cut into `area` strips of N / area consecutive positions, and
    each head's 3 * hd channels are [q | k | v].  The output, back in
    [B, dim, H, W], gains a 7x7 depthwise conv of v (the positional
    encoding) and goes through the 1x1 projection.  An area that does not
    divide H * W raises, as ultralytics' reshape does."""

    def __init__(self, dim: int, num_heads: int, area: int = 1):
        super().__init__()
        self.dim, self.num_heads, self.area = dim, num_heads, area
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.qkv = Conv(dim, 3 * dim, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 7, 1, groups=dim, act=False)

    def forward(self, x):
        b, _, hh, ww = x.shape
        n, a, heads, hd = hh * ww, self.area, self.num_heads, self.head_dim
        if n % a:
            raise ValueError(f"area {a} does not divide {hh}x{ww} "
                             f"positions")
        # NHWC, a view of the conv's channels_last output on the card:
        # [B * area, N / area, heads, 3 * hd]
        qkv = self.qkv(x).permute(0, 2, 3, 1).reshape(b * a, n // a, heads,
                                                       3 * hd)
        q, k, v = qkv.transpose(1, 2).split(hd, dim=-1)
        out = area_attention(q, k, v, self.scale)       # [B*a, heads, s, hd]
        out = out.transpose(1, 2).reshape(b, hh, ww, self.dim)
        v = qkv[..., 2 * hd:].reshape(b, hh, ww, self.dim)
        out = out.permute(0, 3, 1, 2) + self.pe(v.permute(0, 3, 1, 2))
        return self.proj(out)


class ABlock(nn.Module):
    """Area attention and a 1x1 MLP of int(dim * mlp_ratio) channels, both
    residual (YOLO12)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 1.2,
                 area: int = 1):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.attn = AAttn(dim, num_heads, area)
        self.mlp = nn.Sequential(Conv(dim, hidden, 1),
                                 Conv(hidden, dim, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    """R-ELAN block (YOLO12): cv1 to c_ = cout / 2 channels, n blocks each
    on the previous one's output (two ABlocks of c_ // 32 heads with a2,
    else a C3k), cv2 over the concatenation of all of them.  With a2 and
    `residual` (scales l and x) the block returns x + gamma * out, gamma a
    learned per-channel layer scale, in f32 and rounded once to x's
    dtype."""

    def __init__(self, cin: int, cout: int, n: int = 1, a2: bool = True,
                 area: int = 1, residual: bool = False,
                 mlp_ratio: float = 2.0):
        super().__init__()
        c_ = cout // 2
        if c_ % 32:
            raise ValueError(f"A2C2f needs hidden channels in multiples of "
                             f"32, got {c_}")
        self.cv1 = Conv(cin, c_, 1, 1)
        self.cv2 = Conv((1 + n) * c_, cout, 1, 1)
        self.gamma = (nn.Parameter(torch.full((cout,), 0.01))
                      if a2 and residual else None)
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock(c_, c_ // 32, mlp_ratio, area)
                            for _ in range(2)))
            if a2 else C3(c_, c_, 2, True, e=0.5, k=3)
            for _ in range(n))

    def forward(self, x):
        ys = [self.cv1(x)]
        for block in self.m:
            ys.append(block(ys[-1]))
        y = self.cv2(torch.cat(ys, dim=1))
        if self.gamma is None:
            return y
        return (x.float() + self.gamma.float()[:, None, None] * y.float()
                ).to(x.dtype)


class Upsample(nn.Module):
    """2x nearest-neighbour upsample (exact pixel replication): kernel K4
    on CUDA, forward and gradient; the reference's broadcast form on the
    CPU (ops/cuda_upsample.py)."""

    def forward(self, x):
        return cuda_upsample.upsample2x(x)


class Concat(nn.Module):
    """Channel concatenation of several inputs."""

    def forward(self, xs: Sequence[torch.Tensor]):
        return torch.cat(list(xs), dim=1)


def fuse_tree(module: nn.Module) -> nn.Module:
    """Fold BN into conv weights in every Conv under `module` (in place)."""
    for m in list(module.modules()):
        if isinstance(m, Conv):
            m.fuse()
    return module
