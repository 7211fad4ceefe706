"""The plain versions of kernels K5 (sigma-clipped statistics) and K6
(histogram equalisation) against the JAX package, on the CPU with the
same seeded planes: the per-plane XLA functions (ops/stats, ops/histeq)
and the Pallas batch kernels, which run in interpret mode on the CPU.

Tolerances: n_valid exactly; medians exactly against the Pallas kernel
(the same bisection and pin); mean, std and the bounds within atol 1e-6
and rtol 1e-4, as tests/test_pallas_stats.py holds the Pallas kernel to
the XLA version (f32 sums in another order, amplified by sigma in the
bounds).  Histogram equalisation within atol 2e-6
(tests/test_pallas_histeq.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_yolo_tpu.ops.histeq import equalize_hist as jax_equalize_hist
from caesar_yolo_tpu.ops.pallas_histeq import equalize_hist_batch
from caesar_yolo_tpu.ops.pallas_stats import sigma_clipped_stats_batch
from caesar_yolo_tpu.ops.stats import sigma_clipped_stats as jax_stats
from caesar_yolo_tpu_torch.ops import cuda_histeq, cuda_stats
from caesar_yolo_tpu_torch.ops.histeq import equalize_hist
from caesar_yolo_tpu_torch.ops.stats import (
    clip_stats_plain,
    masked_max,
    masked_min,
    sigma_clip_bounds,
    sigma_clipped_stats,
    valid_mask,
)

torch.set_num_threads(1)


def planes(seed, h=48, w=64):
    """Noise planes and the edge cases: empty, NaN-blanked pixels,
    constant, a bright source (clipping bites), heavy duplicates (the
    pin's fallback), a masked border."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((7, h, w)).astype(np.float32)
    x[0] = 0.0
    x[1, 3:9, 4:7] = np.nan
    x[2] = 1.5
    x[3, 10:14, 10:14] += 100.0
    x[4, : h // 2] = 0.25
    x[5, :, :3] = 0.0
    x[6] *= 1e4                                  # large magnitudes
    return x


@pytest.mark.parametrize("sigmas", [(3.0, 3.0), (1.0, 20.0), (0.0, 20.0),
                                    (50.0, 50.0)])
def test_clip_stats_plain_matches_jax(sigmas):
    x = planes(1)
    m = (x != 0) & np.isfinite(x)
    sl, su = sigmas
    stats, counts = clip_stats_plain(torch.from_numpy(x), None, sl, su)
    pallas = [np.asarray(o) for o in sigma_clipped_stats_batch(
        jnp.asarray(x), jnp.asarray(m), sl, su)]
    for i in range(len(x)):
        ref = jax_stats(jnp.asarray(x[i]), jnp.asarray(m[i]), sl, su)
        assert int(counts[i, 0]) == int(ref[5]) == int(pallas[5][i])
        got = stats[i].numpy()
        if i == 0:                               # empty: NaN statistics
            assert np.isnan(got).all() and int(counts[i, 1]) == 0
            continue
        np.testing.assert_allclose(got, [float(r) for r in ref[:5]],
                                   atol=1e-6, rtol=1e-4, err_msg=str(i))
        np.testing.assert_allclose(got, [p[i] for p in pallas[:5]],
                                   atol=1e-6, rtol=1e-4, err_msg=str(i))
        assert got[1] == pallas[1][i], i         # the median, exactly


def test_median_exact_with_duplicates():
    """sigma 50 keeps every valid pixel: the median is numpy's exactly,
    also when more than half of the plane holds one value."""
    x = planes(2)
    x[4, :, :] = np.where(np.arange(64) < 40, 0.25, x[4])
    med = sigma_clipped_stats(torch.from_numpy(x), None, 50.0, 50.0)[1]
    for i in (3, 4, 5, 6):
        v = x[i][(x[i] != 0) & np.isfinite(x[i])]
        assert float(med[i]) == float(np.median(v)), i


def test_explicit_mask_and_bounds():
    """An explicit mask replaces the values' own on the CPU, as in the
    reference's signature; sigma_clip_bounds returns the last bounds."""
    x = planes(3)
    mask = np.ones_like(x, bool)
    mask[:, :, :8] = False
    mask &= np.isfinite(x)
    got = sigma_clipped_stats(torch.from_numpy(x), torch.from_numpy(mask),
                              2.0, 5.0)
    lo, hi = sigma_clip_bounds(torch.from_numpy(x), torch.from_numpy(mask),
                               2.0, 5.0)
    for i in range(1, len(x)):
        ref = jax_stats(jnp.asarray(x[i]), jnp.asarray(mask[i]), 2.0, 5.0)
        np.testing.assert_allclose([float(g[i]) for g in got[:5]],
                                   [float(r) for r in ref[:5]],
                                   atol=1e-6, rtol=1e-4)
        assert int(got[5][i]) == int(ref[5])
        assert (float(lo[i]), float(hi[i])) == (float(got[3][i]),
                                                float(got[4][i]))


def test_wrappers_take_the_plain_version_on_the_cpu():
    x = torch.from_numpy(planes(4))
    stats, counts = cuda_stats.clip_stats(x, 3.0, 3.0)
    ref_stats, ref_counts = clip_stats_plain(x, None, 3.0, 3.0)
    assert torch.equal(counts, ref_counts)
    assert torch.equal(stats.isnan(), ref_stats.isnan())
    assert torch.equal(stats.nan_to_num(), ref_stats.nan_to_num())
    assert torch.equal(cuda_histeq.equalize_hist_batch(x).nan_to_num(),
                       equalize_hist(x).nan_to_num())
    assert cuda_stats.clip_stats.launches == 0
    assert cuda_histeq.equalize_hist_batch.launches == 0


def test_masked_min_max():
    x = torch.from_numpy(planes(5))
    m = valid_mask(x)
    np.testing.assert_array_equal(
        masked_min(x, m, dim=(1, 2)).numpy(),
        np.asarray([np.min(p[(p != 0) & np.isfinite(p)], initial=np.inf)
                    for p in x.numpy()]))
    assert float(masked_max(x, m)) == float(
        np.max(x.numpy()[m.numpy()]))
    assert float(masked_min(x[0], m[0])) == float("inf")


@pytest.mark.parametrize("shape", [(3, 64, 64), (2, 96, 100), (2, 33, 47)])
def test_equalize_hist_plain_matches_jax(shape):
    rng = np.random.default_rng(shape[1])
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, 10:16, 10:16] += 200.0
    x[:, :2, :2] = 0.0
    x[-1, 5, 7] = np.nan              # a NaN makes the plane's output NaN
    got = equalize_hist(torch.from_numpy(x)).numpy()
    batch = np.asarray(equalize_hist_batch(jnp.asarray(x)))
    for i in range(len(x)):
        ref = np.asarray(jax_equalize_hist(jnp.asarray(x[i])))
        np.testing.assert_array_equal(np.isnan(got[i]), np.isnan(ref))
        np.testing.assert_allclose(got[i], ref, atol=2e-6)
        np.testing.assert_allclose(got[i], batch[i], atol=2e-6)
    assert np.isnan(got[-1]).all()
    assert (got[0] >= 0).all() and (got[0] <= 1).all()
