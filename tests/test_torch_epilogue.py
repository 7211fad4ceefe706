"""The port's bf16 inference arithmetic (models/cuda_epilogue.py, kernel
K10's plain version, and the conv layers that use it) against the JAX
package on the CPU.

Rules, each measured on these inputs:
  - `silu` in bf16 equals JAX's bf16 `silu` bit for bit on every finite
    bf16 value whose evaluation meets no value of magnitude 2^-126 or
    less other than 0.  XLA's CPU flushes subnormal inputs, intermediates
    and results to zero (JAX gives +-0 there: 511 of the 65280 finite
    values, with |y| <= 2^-125 or y near -87.5); PyTorch keeps them, on
    the CPU and on the card;
  - the epilogue's plain version equals JAX's `(y * scale + b)` or
    `(y + b)` in f32, `.astype(bf16)`, then `silu`, evaluated op by op,
    bit for bit on the same f32 y;
  - the bf16 Conv (fused and unfused) and Conv2dRaw against JAX's on the
    same weights and input: every output within one bf16 ulp of JAX's and
    at most 1% of them not equal (the convs' f32 sums are taken in
    another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from caesar_yolo_tpu.models.layers import Conv as JConv
from caesar_yolo_tpu.models.layers import Conv2dRaw as JConv2dRaw
from caesar_yolo_tpu.models.layers import silu as jsilu
from caesar_yolo_tpu_torch.models import cuda_epilogue
from caesar_yolo_tpu_torch.models.layers import (Conv, Conv2dRaw, cast_weights,
                                                 silu)

torch.set_num_threads(1)

TINY = 2.0 ** -126           # the least normal f32 (and bf16) magnitude
ULP_SHARE = 0.01
# finite bf16 values on which JAX's silu flushes what the port keeps
FLUSHED = 511


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy().view(np.uint32)


def _subnormal(t: torch.Tensor) -> torch.Tensor:
    a = t.float().abs()
    return (a > 0) & (a <= TINY)


def assert_silu_bits(got: torch.Tensor, ref: np.ndarray,
                     z: torch.Tensor) -> int:
    """got = the port's bf16 silu(z), ref = JAX's (as f32): bit-equal
    wherever the port's evaluation (z, exp(-z), 1 / (1 + exp(-z)), the
    result) meets no nonzero value of magnitude 2^-126 or less; there
    JAX's flushed result is +-0 if it differs.  Returns the number of
    values that differ."""
    e = torch.exp(-z)
    r = 1 / (1 + e)
    flushed = (_subnormal(z) | _subnormal(e) | _subnormal(r)
               | _subnormal(got)).numpy()
    same = _bits(got) == ref.view(np.uint32)
    assert (same | (flushed & (ref == 0))).all(), \
        z[torch.from_numpy(~same & ~(flushed & (ref == 0)))]
    return int((~same).sum())


def test_silu_matches_jax_on_every_finite_bf16_value():
    y = torch.arange(2 ** 16, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    y = y[torch.isfinite(y)]
    assert len(y) == 2 ** 16 - 256
    ref = np.asarray(jsilu(jnp.asarray(y.float().numpy()).astype(
        jnp.bfloat16)).astype(jnp.float32))
    assert assert_silu_bits(silu(y), ref, y) == FLUSHED
    # F.silu, one rounding, is not the reference's form: it differs on
    # 3.7% of the values in [-12, 12] (1227 of 33410)
    near = y.float().abs() <= 12
    assert int((F.silu(y) != silu(y))[near].sum()) == 1227
    # in f32 it is F.silu
    x = torch.linspace(-20, 20, 1001)
    assert torch.equal(silu(x), F.silu(x))


@pytest.mark.parametrize("act", [True, False], ids=["silu", "linear"])
@pytest.mark.parametrize("bn", [False, True], ids=["bias", "bn_scale"])
def test_epilogue_plain_matches_jax(bn, act):
    rng = np.random.default_rng(3 + 2 * bn + act)
    c = 37
    y = (rng.standard_normal((2, 9, 11, c)) * rng.uniform(0.1, 30, c)
         ).astype(np.float32)
    scale = rng.uniform(0.2, 3.0, c).astype(np.float32)
    shift = rng.standard_normal(c).astype(np.float32)
    jy = jnp.asarray(y)
    if bn:
        jy = jy * jnp.asarray(scale)
    ref = (jy + jnp.asarray(shift)).astype(jnp.bfloat16)
    pre = torch.tensor(np.asarray(ref.astype(jnp.float32))).bfloat16()
    if act:
        ref = jsilu(ref)
    ref = np.asarray(ref.astype(jnp.float32))
    got = cuda_epilogue.epilogue_plain(
        torch.from_numpy(y).permute(0, 3, 1, 2),
        torch.from_numpy(scale) if bn else None, torch.from_numpy(shift),
        act)
    assert got.dtype == torch.bfloat16
    got_nhwc = got.permute(0, 2, 3, 1).contiguous()
    if act:
        assert_silu_bits(got_nhwc.reshape(-1), ref.reshape(-1),
                         pre.reshape(-1))
    else:
        np.testing.assert_array_equal(_bits(got_nhwc), ref.view(np.uint32))
    assert torch.equal(got, cuda_epilogue.conv_epilogue(
        torch.from_numpy(y).permute(0, 3, 1, 2),
        torch.from_numpy(scale) if bn else None, torch.from_numpy(shift),
        act))


def _bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance of two bf16-valued f32 arrays in bf16 steps."""
    def ordered(v):
        i = (v.view(np.uint32) >> 16).astype(np.int64)
        return np.where(i & 0x8000, 0x8000 - i, i)
    return np.abs(ordered(a) - ordered(b))


# (kind, cin, cout, k, stride, groups, act)
LAYERS = (
    ("fused", 16, 24, 3, 1, 1, True),
    ("fused", 24, 40, 3, 2, 1, True),
    ("fused", 40, 40, 3, 1, 40, False),
    ("unfused", 16, 32, 1, 1, 1, True),
    ("unfused", 19, 21, 3, 2, 1, True),
    ("raw", 32, 5, 1, 1, 1, False),
    ("raw", 64, 64, 1, 1, 1, False),
)


@pytest.mark.parametrize("case", LAYERS,
                         ids=lambda c: "-".join(str(v) for v in c))
def test_bf16_conv_layers_match_jax(case):
    kind, cin, cout, k, stride, groups, act = case
    rng = np.random.default_rng(cin * cout + k)
    x = rng.standard_normal((2, 13, 15, cin)).astype(np.float32) * 2
    w = (rng.standard_normal((k, k, cin // groups, cout))
         / np.sqrt(cin // groups * k * k)).astype(np.float32)
    if kind == "raw":
        jmod, tmod = JConv2dRaw(cin, cout, k), Conv2dRaw(cin, cout, k)
        params = {"w": w, "b": rng.standard_normal(cout).astype(np.float32)}
        tmod.b.data = torch.from_numpy(params["b"])
    else:
        jmod = JConv(cin, cout, k, stride, groups, act)
        tmod = Conv(cin, cout, k, stride, groups, act)
        bn = {"gamma": rng.uniform(0.5, 2, cout), "beta":
              rng.standard_normal(cout), "mean": rng.standard_normal(cout),
              "var": rng.uniform(0.3, 3, cout)}
        bn = {n: v.astype(np.float32) for n, v in bn.items()}
        params = {"w": w, "bn": bn}
        for n, v in bn.items():
            getattr(tmod.bn, n).data = torch.from_numpy(v)
    tmod.w.data = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    tmod.eval()
    if kind == "fused":
        params = jmod.fuse(params)
        tmod.fuse()
    cast_weights(tmod, torch.bfloat16)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    ref = np.asarray(jax.jit(jmod.__call__)(
        params, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16())
    assert got.dtype == torch.bfloat16
    d = _bf16_ulps(got.float().permute(0, 2, 3, 1).numpy(), ref)
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= ULP_SHARE, (d > 0).mean()
