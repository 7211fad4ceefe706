"""Fused attention for the YOLO11 C2PSA stage (kernel K2).

Counterpart of caesar_yolo_tpu/models/pallas_attn.py.  `attention`
computes softmax(q k^T * scale) v per (batch, head) with the numerics of
the reference: f32 scores multiplied by `scale` after the dot, a
max-subtracted f32 softmax, probabilities normalised and THEN cast to
the compute dtype, f32 accumulation of the PV product, output in the
compute dtype.

On a CUDA tensor it launches the hand-written kernel in csrc/attn.cu: on
bf16, tensor-core MMAs with each query row's whole f32 score row kept on
chip; on f32, scalar FMAs (see the source for its design and bound).  On
a CPU tensor it runs `attention_plain`, the same function in PyTorch.

`fused_attention` is the differentiable form the model calls: an
autograd Function whose forward is `attention` and whose backward is
`attention_backward`, the two launches of csrc/attn_bwd.cu on CUDA (no
[N, N] tensor in device memory; dS fed to the tensor cores as a hi + lo
pair of bf16 values) and, on the CPU, autograd through `attention_plain`
-- the reference's custom VJP, which recomputes through `_attention_ref`
(pallas_attn.py:106-128).  tests/test_torch_attn_tc.py emulates the
kernels' bf16 arithmetic on the CPU against the rules below.

Under torch.export `attention` calls the op caesar_yolo::attention
(utils/portable.py), whose body is the same dispatch; export traces no
gradient, so the backward has no op.
"""

from __future__ import annotations

import ctypes

import torch

from caesar_yolo_tpu_torch import cuda_build
from caesar_yolo_tpu_torch.utils import portable

# The reference's gate for its fused kernel (pallas_attn.py:48): other
# sequence lengths take its einsum branch, which the port follows in
# plain PyTorch (models/layers.py Attention).
MAX_N = 2048
# head widths the kernel takes; on CUDA it raises for others
KERNEL_KD = (16, 32, 64)
KERNEL_MAX_HD = 256

# bf16 parity rule of the kernel against `attention_plain`.  The two sum
# in f32 in different orders, so a bf16 output may round to the
# neighbouring value: at most one ulp at the largest outputs (|out| < 1 on
# unit-variance inputs, ulp 3.9e-3) and on few elements.  A kernel that
# rounds p before normalising (online softmax) also stays within one ulp
# but moves about half of all outputs; the share of changed elements is
# what tells it apart.
BF16_ATOL = 4e-3
BF16_MAX_CHANGED_SHARE = 1e-2

# bf16 parity rule of the backward kernel against `attention_backward_plain`
# (per gradient).  dP is rounded to bf16 after an f32 sum, and the kernel
# sums in another order than PyTorch's matmul, so some dP elements round
# to the neighbouring bf16 value; each such flip moves dS by p * ulp(dP)
# and reaches the dq and dk elements of its row or column.  So a gradient
# may differ by one bf16 ulp of its largest magnitude (2^-8 of max |ref|)
# on a small share of its elements (the tensor-core kernel on the H100 at
# [16,4,400,32/64]: 0.27% of dq and dk, 0.08% of dv changed).
BWD_BF16_REL_ATOL = 2 ** -8
BWD_BF16_MAX_CHANGED_SHARE = 1e-2

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_gate(n: int) -> bool:
    """True when the reference dispatches sequence length `n` to its
    fused kernel (n % 8 == 0 and 8 <= n <= MAX_N), whatever the widths."""
    return n % 8 == 0 and 8 <= n <= MAX_N


def bf16_mismatch(got: torch.Tensor, ref: torch.Tensor) -> str | None:
    """None when bf16 outputs `got` and `ref` agree by the bf16 parity
    rule, else what differs."""
    diff = (got.float() - ref.float()).abs()
    err = diff.max().item()
    share = (diff > 0).float().mean().item()
    if err > BF16_ATOL or share > BF16_MAX_CHANGED_SHARE:
        return (f"max abs err {err:.3g} (limit {BF16_ATOL}), changed share "
                f"{share:.3g} (limit {BF16_MAX_CHANGED_SHARE})")
    return None


def bwd_bf16_mismatch(got, ref) -> str | None:
    """None when the bf16 gradients `got` (dq, dk, dv) agree with `ref` by
    the backward's bf16 parity rule, else what differs."""
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        diff = (g.float() - r.float()).abs()
        limit = BWD_BF16_REL_ATOL * r.float().abs().max().item()
        err = diff.max().item()
        share = (diff > 0).float().mean().item()
        if err > limit or share > BWD_BF16_MAX_CHANGED_SHARE:
            return (f"{name}: max abs err {err:.3g} (limit {limit:.3g}), "
                    f"changed share {share:.3g} (limit "
                    f"{BWD_BF16_MAX_CHANGED_SHARE})")
    return None


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q, k [B, H, N, kd]; v [B, H, N, hd] -> [B, H, N, hd] in v's dtype.
    The kernel's arithmetic in PyTorch (pallas_attn._attention_ref)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    p = p.to(v.dtype).float()
    return torch.matmul(p, v.float()).to(v.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """q, k [B, H, N, kd]; v [B, H, N, hd] -> [B, H, N, hd].

    CUDA tensors launch the kernel (and raise on shapes or dtypes it does
    not take); CPU tensors take `attention_plain`."""
    if portable.exporting():
        return torch.ops.caesar_yolo.attention(q, k, v, float(scale))
    if not q.is_cuda:
        return attention_plain(q, k, v, scale)
    b, h, n, kd = q.shape
    hd = v.shape[-1]
    if (k.shape != q.shape or v.shape[:3] != q.shape[:3]
            or not (q.dtype == k.dtype == v.dtype)
            or q.dtype not in _DTYPE_CODES or not fused_gate(n)
            or kd not in KERNEL_KD or not 1 <= hd <= KERNEL_MAX_HD):
        raise ValueError(
            f"attention kernel does not take q{tuple(q.shape)} "
            f"k{tuple(k.shape)} v{tuple(v.shape)} {q.dtype}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(v)
    lib = cuda_build.load("attn")
    fn = lib.cy_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    attention.launches += 1
    cuda_build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, h, n, kd, hd,
                        _DTYPE_CODES[q.dtype], float(scale),
                        cuda_build.stream_ptr(q.device)),
                     "attention kernel")
    return out


cuda_build.counters(attention, "launches")


@torch.library.custom_op("caesar_yolo::attention", mutates_args=())
def _attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    return attention(q, k, v, scale).contiguous()


@_attention_op.register_fake
def _(q, k, v, scale):
    return v.new_empty(v.shape)


def attention_backward_plain(q, k, v, g, scale):
    """(dq, dk, dv) of `attention_plain` for the output cotangent g, by
    autograd through it: the reference's VJP, which differentiates
    `_attention_ref` (pallas_attn.py:121-125), with the same rounding
    points (dP and dv rounded to the compute dtype)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_plain(*leaves, scale)
        return torch.autograd.grad(out, leaves, g)


def attention_backward(q, k, v, g, scale):
    """(dq, dk, dv) of softmax(q k^T * scale) v for the output cotangent g
    [B, H, N, hd].  CUDA tensors launch the kernel of csrc/attn_bwd.cu
    (and raise on what it does not take); CPU tensors take
    `attention_backward_plain`."""
    if not q.is_cuda:
        return attention_backward_plain(q, k, v, g, scale)
    b, h, n, kd = q.shape
    hd = v.shape[-1]
    if (k.shape != q.shape or v.shape[:3] != q.shape[:3]
            or g.shape != v.shape
            or not (q.dtype == k.dtype == v.dtype == g.dtype)
            or q.dtype not in _DTYPE_CODES or not fused_gate(n)
            or kd not in KERNEL_KD or not 1 <= hd <= KERNEL_MAX_HD):
        raise ValueError(
            f"attention backward kernel does not take q{tuple(q.shape)} "
            f"v{tuple(v.shape)} dO{tuple(g.shape)} {q.dtype}/{g.dtype}")
    q, k, v, g = (t.contiguous() for t in (q, k, v, g))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # per query row the softmax max m, its sum l and D = rowsum(p dP), from
    # the first launch to the second: no [B, H, N, N] tensor
    stats = torch.empty((3, b, h, n), dtype=torch.float32, device=q.device)
    fn = cuda_build.load("attn_bwd").cy_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    attention_backward.launches += 1
    cuda_build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), stats.data_ptr(), b, h, n, kd, hd,
                        _DTYPE_CODES[q.dtype], float(scale),
                        cuda_build.stream_ptr(q.device)),
                     "attention backward kernel")
    return dq, dk, dv


cuda_build.counters(attention_backward, "launches")


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return attention(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*attention_backward(q, k, v, g, ctx.scale), None)


def fused_attention(q, k, v, scale):
    """Differentiable `attention`: forward through it, backward through
    `attention_backward` (the kernel on CUDA, the plain VJP on the CPU)."""
    return _FusedAttention.apply(q, k, v, scale)
