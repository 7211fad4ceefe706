"""K2's tensor-core arithmetic, emulated on the CPU in plain PyTorch and
held to the plain versions by the unchanged bf16 rules of cuda_attn.

On bf16 inputs csrc/attn.cu and csrc/attn_bwd.cu take every product by
mma.sync m16n8k16 with f32 accumulation: a product of two bf16 values is
exact in f32, and the sums run in f32, one 16-element k-step after
another into the same accumulator.  `mma` below does the same: each
k-step's 16 products summed in f32, added in order to an f32 sum.

Shown here, at yolo11l's C2PSA shape and at a ragged one:
(a) the backward whose dq and dk take dS as a split pair, hi = bf16(dS)
    and lo = bf16(dS - hi), two MMAs into one accumulator, passes
    `cuda_attn.bwd_bf16_mismatch`;
(b) the same with dS rounded once to bf16 fails it: the tensor cores may
    not be fed a single bf16 dS;
(c) the forward, p normalised and then rounded to bf16, PV accumulated
    over the keys in k-steps, passes `cuda_attn.bf16_mismatch`.
The plain versions are held to the JAX package's Pallas attention by
tests/test_torch_kernels_train.py and tests/test_torch_parity.py.
"""

import re
import shutil

import numpy as np
import pytest
import torch

from caesar_yolo_tpu_torch import cuda_build
from caesar_yolo_tpu_torch.models import cuda_attn

torch.set_num_threads(1)

K_STEP = 16                       # the k depth of one m16n8k16 MMA
# (b, h, n, kd, hd): yolo11l@640's C2PSA, and a ragged N with a wide head
SHAPES = [(2, 4, 400, 32, 64), (2, 2, 72, 32, 160)]


def _inputs(shape, seed=0):
    b, h, n, kd, hd = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, h, n, d)).astype(
        np.float32)).bfloat16() for d in (kd, kd, hd, hd)]


def mma(a_parts, b):
    """sum_k a[..., k] b[..., k, :] for f32 tensors holding bf16 values,
    as the kernels' MMAs take it: per k-step of 16, the products of each
    part of A (in order) summed in f32 and added to one f32 accumulator."""
    acc = torch.zeros(*a_parts[0].shape[:-1], b.shape[-1])
    for k0 in range(0, b.shape[-2], K_STEP):
        for a in a_parts:
            acc = acc + torch.matmul(a[..., k0:k0 + K_STEP],
                                     b[..., k0:k0 + K_STEP, :])
    return acc


def _bf16(x):
    return x.bfloat16().float()


def forward_tc(q, k, v, scale):
    """The forward kernel's arithmetic: f32 scores from MMAs, then the
    scale; a max-subtracted softmax in f32, p rounded after normalising;
    PV by MMAs, rounded once."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    s = mma([qf], kf.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = _bf16(e / e.sum(dim=-1, keepdim=True))
    return mma([p], vf).bfloat16()


def backward_tc(q, k, v, g, scale, split_ds):
    """The backward kernels' arithmetic: p in f32 and p_c = bf16(p); dP by
    MMAs, then rounded to bf16; dS = p (dP - rowsum(p dP)) scale in f32;
    dv = p_c^T dO, and dq = dS k, dk = dS^T q with dS fed as hi + lo
    (split_ds) or as bf16(dS) alone; each gradient rounded once."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    s = mma([qf], kf.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    dp = _bf16(mma([gf], vf.transpose(-1, -2)))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True)) * scale
    hi = _bf16(ds)
    parts = [hi, _bf16(ds - hi)] if split_ds else [hi]
    dq = mma(parts, kf)
    dk = mma([t.transpose(-1, -2) for t in parts], qf)
    dv = mma([_bf16(p).transpose(-1, -2)], gf)
    return tuple(t.bfloat16() for t in (dq, dk, dv))


@pytest.mark.parametrize("shape", SHAPES)
def test_split_ds_backward_passes_the_rule(shape):
    """(a) dS as hi + lo: each product exact, the remainder dropped is
    ~2^-16 of dS; within the backward's bf16 rule."""
    q, k, v, g = _inputs(shape)
    scale = shape[3] ** -0.5
    got = backward_tc(q, k, v, g, scale, split_ds=True)
    ref = cuda_attn.attention_backward_plain(q, k, v, g, scale)
    assert cuda_attn.bwd_bf16_mismatch(got, ref) is None


@pytest.mark.parametrize("shape", SHAPES)
def test_single_bf16_ds_backward_fails_the_rule(shape):
    """(b) dS rounded once to bf16 moves far more than 1% of dq's (and
    dk's) elements: the rule sees it."""
    q, k, v, g = _inputs(shape)
    scale = shape[3] ** -0.5
    got = backward_tc(q, k, v, g, scale, split_ds=False)
    ref = cuda_attn.attention_backward_plain(q, k, v, g, scale)
    why = cuda_attn.bwd_bf16_mismatch(got, ref)
    assert why is not None and why.startswith("dq")
    # dv takes no dS: it stays within the rule
    assert cuda_attn.bwd_bf16_mismatch(got[2:], ref[2:]) is None


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_passes_the_rule(shape):
    """(c) p normalised then rounded, PV summed by k-steps over the keys:
    within the forward's bf16 rule of the plain version."""
    q, k, v, _ = _inputs(shape)
    scale = shape[3] ** -0.5
    got = forward_tc(q, k, v, scale)
    ref = cuda_attn.attention_plain(q, k, v, scale)
    assert cuda_attn.bf16_mismatch(got, ref) is None


def test_kernel_library_follows_the_shared_header(tmp_path, monkeypatch):
    """A kernel library's file name hashes its source and the headers it
    includes, so an edit of the tensor-core header rebuilds attn and
    attn_bwd instead of loading a stale library, and leaves the libraries
    that do not include it alone."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", str(csrc))
    before = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    with open(csrc / "mma_bf16.cuh", "a") as f:
        f.write("\n// edited\n")
    for name, path in before.items():
        assert (cuda_build.library_path(name) != path) == (
            name in ("attn", "attn_bwd"))
    for name in cuda_build.SOURCES:
        with open(csrc / f"{name}.cu") as f:
            includes = set(re.findall(r'#include "([^"]+)"', f.read()))
        assert includes == set(cuda_build.HEADERS.get(name, [])), name
