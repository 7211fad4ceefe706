"""The port's plain CLAHE (kernel K7's plain version, ops/clahe.py and the
CPU route of ops/cuda_clahe.py) against the JAX package on the CPU: the
XLA gather form (caesar_yolo_tpu/ops/clahe.equalize_adapthist) on the
shapes of tests/test_pallas_clahe.py, both clip limits and NaN, all-zero
and constant planes, and the Pallas batch form in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_yolo_tpu.ops import pallas_clahe
from caesar_yolo_tpu.ops import transforms as jt
from caesar_yolo_tpu.ops.clahe import equalize_adapthist
from caesar_yolo_tpu_torch.ops import clahe, cuda_clahe
from caesar_yolo_tpu_torch.ops import transforms as tt

torch.set_num_threads(1)

# Measured: at most 4.2e-7 from either JAX form on these planes (the
# redistribution's sums and the CDF cumsum run in another order, and the
# port blends as lerps; all outputs in [0, 1]).
TOL = 1e-6


def _planes(seed, b, h, w):
    """Noise with a bright source per plane (tests/test_pallas_clahe.py's
    radio_batch)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w)).astype(np.float32)
    for i in range(b):
        cy = int(rng.integers(12, h - 12))
        cx = int(rng.integers(12, w - 12))
        x[i, cy - 4:cy + 4, cx - 4:cx + 4] += 150.0
    return x


def _xla(x, clip_limit):
    return np.stack([np.asarray(equalize_adapthist(jnp.asarray(im),
                                                   clip_limit=clip_limit))
                     for im in x])


@pytest.mark.parametrize("clip_limit", [0.03, 0.01])
@pytest.mark.parametrize("shape", [(2, 132, 132), (1, 64, 64),
                                   (2, 128, 256), (1, 96, 100)])
def test_plain_matches_xla_form(shape, clip_limit):
    x = _planes(sum(shape), *shape)
    got = cuda_clahe.equalize_adapthist_batch(torch.from_numpy(x),
                                              clip_limit).numpy()
    np.testing.assert_allclose(got, _xla(x, clip_limit), atol=TOL, rtol=0)
    assert torch.equal(torch.from_numpy(got), clahe.equalize_adapthist_plain(
        torch.from_numpy(x), clip_limit))


@pytest.mark.parametrize("shape,clip_limit", [((2, 132, 132), 0.03),
                                              ((1, 96, 100), 0.03),
                                              ((1, 96, 100), 0.01)])
def test_plain_matches_pallas_interpret(monkeypatch, shape, clip_limit):
    monkeypatch.setattr(pallas_clahe, "INTERPRET", True)
    x = _planes(sum(shape), *shape)
    ref = np.asarray(pallas_clahe.equalize_adapthist_batch(
        jnp.asarray(x), clip_limit=clip_limit))
    got = cuda_clahe.equalize_adapthist_batch(torch.from_numpy(x),
                                              clip_limit).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_nan_zero_and_constant_planes_match_xla_form():
    """A NaN makes the plane's range NaN and every bin 0 (jnp.min
    propagates it, XLA converts NaN to 0); an all-zero and a constant
    plane have span 1, all in bin 0.  All give finite outputs within TOL of
    the XLA form's, and the port's stay exactly uniform."""
    x = _planes(3, 4, 96, 100)
    x[0] = 0.0
    x[1, 40, 7] = np.nan
    x[2] = 7.0
    got = cuda_clahe.equalize_adapthist_batch(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _xla(x, 0.03), atol=TOL, rtol=0)
    for i in (0, 1, 2):
        assert np.ptp(got[i]) == 0.0


def test_histograms_and_blend_steps():
    """The kernel's two passes in plain form: exact counts of th*tw padded
    pixels per tile (the reflect pad counts mirrored pixels), and a blend
    of equal CDFs that returns them exactly."""
    x = torch.from_numpy(_planes(5, 2, 132, 130))
    vmin, span = clahe.value_range(x)
    hist = cuda_clahe.tile_histograms(x, vmin, span)
    th, tw = clahe.tile_size(132, 130)
    assert (th, tw) == (17, 17)
    assert hist.shape == (2, 64, 256)
    assert bool((hist.sum(dim=-1) == th * tw).all())
    cdf = torch.rand(2, 1, 256).cumsum(-1).expand(2, 64, 256).contiguous()
    out = cuda_clahe.blend(x, vmin, span, cdf)
    assert torch.equal(out, torch.gather(
        cdf[:, 0], 1, clahe.bin_index(x, vmin, span).reshape(2, -1)
    ).reshape(out.shape))
    with pytest.raises(ValueError):
        clahe.tile_size(4, 64)


def test_hist_equalizer_adaptive_matches_jax_pipeline(monkeypatch):
    """hist_equalizer(adaptive=True) on a masked 3-channel tile against the
    reference's batch path (its Pallas kernels in interpret mode, on the
    [1, 96, 100] planes compiled above)."""
    monkeypatch.setattr(pallas_clahe, "INTERPRET", True)
    x = _planes(9, 1, 96, 100)[..., None].repeat(3, axis=-1)
    x[..., 1] *= 2.0
    x[:, 10:14, 20:30] = 0.0
    ref, rok = jt.Pipeline([jt.hist_equalizer(adaptive=True)]).apply_batch(
        jnp.asarray(x))
    got, ok = tt.Pipeline([tt.hist_equalizer(adaptive=True)]).apply_batch(
        torch.from_numpy(x))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)
    assert (got.numpy()[:, 10:14, 20:30] == 0).all()


def test_constant_tile_is_degenerate():
    """The port blends equal CDF values as lerps, so a constant tile stays
    exactly constant at every shape (the published fixpoint that
    tests/test_pallas_clahe.py pins on the XLA form at 64x64) and the
    engine's degenerate-channel guard refuses it.  The reference's forms
    may ripple by a few f32 ulps (here both do, at 96x100: the XLA form's
    weighted sum, the Pallas form's 64 hat weights), and the JAX engine
    then predicts on such a tile."""
    t = np.full((1, 96, 100, 1), 2.5, np.float32)
    stage = jt.hist_equalizer(adaptive=True)
    xla, _ = jt.Pipeline([stage]).apply_batch(jnp.asarray(t), native=False)
    pallas, _ = jt.Pipeline([stage]).apply_batch(jnp.asarray(t))
    pipe = tt.Pipeline([tt.hist_equalizer(adaptive=True)])
    got, _ = pipe.apply_batch(torch.from_numpy(t))
    assert np.ptp(got.numpy()) == 0.0
    for ref in (xla, pallas):
        assert np.ptp(np.asarray(ref)) <= TOL
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)
    _, ok = tt.prepare_tiles(torch.from_numpy(t), pipe, 3)
    assert not bool(ok[0])
