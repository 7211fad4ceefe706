"""The training slice's kernels' plain versions against the JAX package,
on the CPU with the same seeded inputs: K2's gradient (the custom VJP of
pallas_attn), K4 (2x upsample, forward and gradient) and K8 (the shear
pass's row shift).  The CUDA kernels are held against these plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_yolo_tpu.models import layers as jax_layers
from caesar_yolo_tpu.models import pallas_attn
from caesar_yolo_tpu.ops import pallas_shift, pallas_upsample
from caesar_yolo_tpu.train.augment import _row_shift_batch
from caesar_yolo_tpu_torch.models import cuda_attn
from caesar_yolo_tpu_torch.models import layers as torch_layers
from caesar_yolo_tpu_torch.ops import cuda_shift, cuda_upsample

torch.set_num_threads(1)


def _qkvg(seed, b, h, n, kd, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32)
            for d in (kd, kd, hd, hd)]


@pytest.mark.parametrize("n", [16, 400])
def test_attention_grads_match_pallas_vjp(monkeypatch, n):
    """dq, dk, dv of the port (autograd through fused_attention, which on
    the CPU runs the plain VJP) against jax.vjp of attention_pallas in
    interpret mode, f32, within 1e-5 of each gradient's largest value
    (f32 sums in another order)."""
    monkeypatch.setattr(pallas_attn, "INTERPRET", True)
    q, k, v, g = _qkvg(n, 2, 2, n, 32, 64)
    scale = 32 ** -0.5
    _, vjp = jax.vjp(lambda a, b_, c: pallas_attn.attention_pallas(
        a, b_, c, scale), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = cuda_attn.fused_attention(*leaves, scale)
    out.backward(torch.from_numpy(g))
    for leaf, r in zip(leaves, ref):
        err = np.abs(leaf.grad.numpy() - r).max()
        assert err <= 1e-5 * np.abs(r).max(), err


def test_attention_bf16_grads_match_pallas_vjp(monkeypatch):
    """In bf16 the plain VJP keeps the reference's rounding points (dP and
    the gradients rounded to bf16 after f32 sums): held to jax.vjp of the
    Pallas attention by the backward's bf16 rule."""
    monkeypatch.setattr(pallas_attn, "INTERPRET", True)
    q, k, v, g = _qkvg(7, 2, 2, 64, 32, 64)
    scale = 32 ** -0.5
    jb = [jnp.asarray(t, jnp.bfloat16) for t in (q, k, v, g)]
    _, vjp = jax.vjp(lambda a, b_, c: pallas_attn.attention_pallas(
        a, b_, c, scale), *jb[:3])
    ref = [torch.from_numpy(np.asarray(t, np.float32)).bfloat16()
           for t in vjp(jb[3])]
    tb = [torch.from_numpy(np.asarray(t, np.float32)).bfloat16() for t in jb]
    got = cuda_attn.attention_backward(*tb, scale)
    assert cuda_attn.bwd_bf16_mismatch(got, ref) is None


def test_bwd_bf16_rule_sees_a_missing_rounding():
    """The backward's bf16 rule passes a change of f32 summation order
    (f64 sums) and fails a backward that skips the rounding of dP."""
    g_ = torch.Generator().manual_seed(0)
    b, h, n, kd, hd = 2, 4, 400, 32, 64
    q, k, v, g = (torch.randn(b, h, n, d, generator=g_).bfloat16()
                  for d in (kd, kd, hd, hd))
    scale = kd ** -0.5
    ref = cuda_attn.attention_backward_plain(q, k, v, g, scale)
    qd, kd_, vd, gd = (t.double() for t in (q, k, v, g))
    s = torch.matmul(qd, kd_.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    pc = p.float().bfloat16().double()

    def grads(dp):
        ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
        return [t.float().bfloat16() for t in (
            torch.matmul(ds, kd_), torch.matmul(ds.transpose(-1, -2), qd),
            torch.matmul(pc.transpose(-1, -2), gd))]

    dp = torch.matmul(gd, vd.transpose(-1, -2))
    assert cuda_attn.bwd_bf16_mismatch(
        grads(dp.float().bfloat16().double()), ref) is None
    assert cuda_attn.bwd_bf16_mismatch(grads(dp), ref) is not None


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 4, 4, 128), (1, 5, 3, 256)])
def test_upsample_matches_pallas(monkeypatch, dtype, shape):
    """K4's plain forward equals upsample2x_pallas (interpret mode) bit for
    bit (pure replication).  NHWC at the reference, NCHW in the port."""
    monkeypatch.setattr(pallas_upsample, "INTERPRET", True)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = np.asarray(pallas_upsample.upsample2x_pallas(jnp.asarray(x, jd)),
                     np.float32)
    xt = torch.from_numpy(x).to(td).permute(0, 3, 1, 2)
    got = cuda_upsample.upsample2x(xt).permute(0, 2, 3, 1).float().numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample_grad_matches_jax(dtype):
    """K4's plain gradient (2x2 window sums in f32, rounded once) against
    jax.vjp of the reference's broadcast form.  f32: within one ulp (XLA
    may add the four values in another order).  bf16: XLA's transpose
    rounds each partial sum to bf16 (found: up to a few bf16 ulps off the
    f32 sum) where K4 sums in f32 and rounds once, so the two stay within
    four bf16 roundings of the window's sum of magnitudes, 4 * 2^-8 * S."""
    x = np.random.default_rng(1).standard_normal((2, 6, 5, 16)).astype(
        np.float32)
    g = np.random.default_rng(2).standard_normal((2, 12, 10, 16)).astype(
        np.float32)
    jd = getattr(jnp, dtype)

    def up(a):
        b, h, w, c = a.shape
        return jnp.broadcast_to(a[:, :, None, :, None, :],
                                (b, h, 2, w, 2, c)).reshape(b, 2 * h, 2 * w, c)

    _, vjp = jax.vjp(up, jnp.asarray(x, jd))
    ref = np.asarray(vjp(jnp.asarray(g, jd))[0], np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    xt.requires_grad_()
    cuda_upsample.upsample2x(xt).backward(
        torch.from_numpy(g).to(xt.dtype).permute(0, 3, 1, 2))
    got = xt.grad.permute(0, 2, 3, 1).float().numpy()
    if dtype == "float32":
        tol = np.spacing(np.abs(ref).astype(np.float32))
    else:
        gb = np.asarray(jnp.asarray(g, jd), np.float32)
        mag = np.abs(gb).reshape(2, 6, 2, 5, 2, 16).sum(axis=(2, 4))
        tol = 4 * 2.0 ** -8 * mag
    assert (np.abs(got - ref) <= tol).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample_concat_grad_matches_jax(monkeypatch, dtype):
    """The neck's concat(upsample(x), y): x's and y's gradients through the
    port's Upsample and Concat, with a channels_last incoming gradient (so
    that K4's backward gets a channel slice of it, as in training), against
    jax.vjp of the JAX package's Upsample (broadcast form) and Concat.
    y's gradient is a slice: equal.  x's: the tolerances of
    test_upsample_grad_matches_jax (f32 one ulp; bf16 four bf16 roundings
    of the window's sum of magnitudes)."""
    monkeypatch.setattr(jax_layers, "_UPSAMPLE_MODE", "broadcast")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 5, 16)).astype(np.float32)
    y = rng.standard_normal((2, 12, 10, 8)).astype(np.float32)
    g = rng.standard_normal((2, 12, 10, 24)).astype(np.float32)
    jd = getattr(jnp, dtype)
    up, cat = jax_layers.Upsample(), jax_layers.Concat()
    _, vjp = jax.vjp(lambda a, b: cat({}, [up({}, a), b]),
                     jnp.asarray(x, jd), jnp.asarray(y, jd))
    ref_x, ref_y = (np.asarray(t, np.float32) for t in vjp(jnp.asarray(g, jd)))
    td = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(td).permute(0, 3, 1, 2).requires_grad_()
    yt = torch.from_numpy(y).to(td).permute(0, 3, 1, 2).requires_grad_()
    gt = torch.from_numpy(g).to(td).permute(0, 3, 1, 2)
    assert gt.is_contiguous(memory_format=torch.channels_last)
    out = torch_layers.Concat()([torch_layers.Upsample()(xt), yt])
    out.backward(gt)
    got_x = xt.grad.permute(0, 2, 3, 1).float().numpy()
    got_y = yt.grad.permute(0, 2, 3, 1).float().numpy()
    np.testing.assert_array_equal(got_y, ref_y)
    if dtype == "float32":
        tol = np.spacing(np.abs(ref_x).astype(np.float32))
    else:
        gb = np.asarray(jnp.asarray(g, jd), np.float32)[..., :16]
        tol = 4 * 2.0 ** -8 * np.abs(gb).reshape(2, 6, 2, 5, 2, 16).sum(
            axis=(2, 4))
    assert (np.abs(got_x - ref_x) <= tol).all()


def test_upsample_plain_backward_is_autograd_of_plain_forward():
    """The explicit backward equals autograd through the broadcast form in
    f32 (both sum four values; here they round alike)."""
    x = torch.randn(2, 8, 3, 4, generator=torch.Generator().manual_seed(3),
                    requires_grad=True)
    g = torch.randn(2, 8, 6, 8, generator=torch.Generator().manual_seed(4))
    cuda_upsample.upsample2x_plain(x).backward(g)
    got = cuda_upsample.upsample2x_backward_plain(g)
    torch.testing.assert_close(got, x.grad, atol=1e-6, rtol=0)


def _shift_inputs(seed, b=2, h=24, w=20, c=3, pad=12):
    rng = np.random.default_rng(seed)
    imgs = rng.random((b, h, w, c), dtype=np.float32)
    shifts = (rng.random((b, h), dtype=np.float32) * 2 - 1) * (pad + 2)
    shifts[0, :4] = [0.0, -pad, pad - 1.0, 3.0]      # integers and the clip
    return imgs, shifts, pad


@pytest.mark.parametrize("pad_val", [114 / 255, 0.0])
def test_row_shift_matches_reference_forms(monkeypatch, pad_val):
    """K8's plain version against the reference's dynamic-slice form
    (_row_shift_batch off the TPU) and the Pallas kernel in interpret mode,
    shifts beyond +-pad included (the clip): within one f32 ulp.  Found:
    about 10% of the outputs one ulp off, because XLA on the CPU contracts
    the lerp a0 * (1 - f) + a1 * f into a fused multiply-add, where the
    port rounds each product (as its kernel, built with -fmad=false, does
    bit for bit); integer shifts and pad_val fills are exact."""
    imgs, shifts, pad = _shift_inputs(0)
    got = cuda_shift.fractional_row_shift_batch(
        torch.from_numpy(imgs), torch.from_numpy(shifts), pad, pad_val).numpy()
    ref = np.asarray(_row_shift_batch(jnp.asarray(imgs), jnp.asarray(shifts),
                                      pad, pad_val))
    monkeypatch.setattr(pallas_shift, "INTERPRET", True)
    ref2 = np.asarray(pallas_shift.fractional_row_shift_batch(
        jnp.asarray(imgs), jnp.asarray(shifts), pad, pad_val))
    for r in (ref, ref2):
        assert (np.abs(got - r) <= np.spacing(np.abs(r))).all()
        assert (np.abs(got - r) > 0).mean() < 0.25
    whole = np.floor(shifts) == shifts
    np.testing.assert_array_equal(got[whole], ref[whole])


@pytest.mark.parametrize("pad_val", [114 / 255, 0.0])
@pytest.mark.parametrize("s,c", [(24, 3), (21, 1)])
def test_row_shift_on_transposed_view_matches_jax_yshear(pad_val, s, c):
    """The y-shear as the port's augment.py runs it, the row shift of the
    canvas's transposed view with no copy, against the reference's
    swapaxes, _row_shift_batch, swapaxes (caesar_yolo_tpu/train/
    augment.py:237-240) on shears like the augmentation's and whole
    shifts: bit-equal to the shift of a contiguous transposed copy; to
    JAX bit-equal where the shift is whole and within one f32 ulp where
    it has a fraction (XLA's FMA contraction, as above)."""
    rng = np.random.default_rng(s + c)
    canvas = rng.random((3, s, s, c), dtype=np.float32)
    pad = s // 2 + 2
    ys = np.arange(s, dtype=np.float32) - (s - 1) / 2
    r = np.array([np.pi / 4, -0.3, 0.0], dtype=np.float32)
    shifts = (np.tan(r)[:, None] * ys[None]).astype(np.float32)
    shifts[2] = np.round(rng.random(s) * 2 * (pad + 2) - pad - 2)
    view = torch.from_numpy(canvas).transpose(1, 2)
    sh = torch.from_numpy(shifts)
    got = cuda_shift.fractional_row_shift_batch(view, sh, pad, pad_val)
    copy = cuda_shift.row_shift_plain(view.contiguous(), sh, pad, pad_val)
    assert torch.equal(got, copy)
    got = got.transpose(1, 2).numpy()
    ref = np.asarray(jnp.swapaxes(_row_shift_batch(
        jnp.swapaxes(jnp.asarray(canvas), 1, 2), jnp.asarray(shifts), pad,
        pad_val), 1, 2))
    assert (np.abs(got - ref) <= np.spacing(np.abs(ref))).all()
    whole = np.broadcast_to((np.floor(shifts) == shifts)[:, None, :, None],
                            got.shape)
    np.testing.assert_array_equal(got[whole], ref[whole])
    assert whole[2].all()
