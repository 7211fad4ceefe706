"""The port's training augmentation against the JAX package on the CPU.

jax.random and torch.Generator draw different numbers from one seed, so
the port applies given draws: each test draws with jax.random exactly as
caesar_yolo_tpu/train/augment.augment_batch does and hands the numbers to
both."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_yolo_tpu.detect.letterbox import PAD_VALUE
from caesar_yolo_tpu.train import augment as jaug
from caesar_yolo_tpu_torch.train import augment as taug

torch.set_num_threads(1)


def jax_draws(key, bsz, degrees=180.0, scale=0.89, flipud=0.5, fliplr=0.5):
    """augment_batch's per-sample draws (augment.py:254-277)."""
    keys = jax.random.split(key, bsz)
    ks = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
    angles = jax.vmap(lambda k: jax.random.uniform(
        k, (), minval=-degrees, maxval=degrees))(ks[:, 0]) * jnp.pi / 180.0
    ss = jax.vmap(lambda k: jax.random.uniform(
        k, (), minval=1.0 - scale, maxval=1.0 + scale))(ks[:, 1])
    do_ud = jax.vmap(lambda k: jax.random.uniform(k) < flipud)(ks[:, 2])
    do_lr = jax.vmap(lambda k: jax.random.uniform(k) < fliplr)(ks[:, 3])
    return [torch.from_numpy(np.array(a)) for a in (angles, ss, do_ud,
                                                    do_lr)]


def smooth_batch(bsz, size, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    imgs = []
    for _ in range(bsz):
        cx, cy = rng.uniform(0.2, 0.8, 2) * size
        img = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * (size / 8) ** 2))
        img = img[..., None] * rng.uniform(0.5, 1.0, 3)
        imgs.append(img + 0.05 * rng.random((size, size, 3)))
    return np.stack(imgs).astype(np.float32)


def test_rot_scale_exact_at_90_multiples():
    """Multiples of 90 degrees at scale 1: the port equals the reference bit
    for bit (rot90, integer shears, identity scale matrices)."""
    imgs = smooth_batch(4, 40)
    angles = np.asarray([0, 1, 2, -1], np.float32) * np.float32(np.pi / 2)
    scales = np.ones(4, np.float32)
    ref = np.asarray(jaug._rot_scale_sample_batch(
        jnp.asarray(imgs), jnp.asarray(angles), jnp.asarray(scales),
        pad_val=PAD_VALUE))
    got = taug._rot_scale_sample_batch(
        torch.from_numpy(imgs), torch.from_numpy(angles),
        torch.from_numpy(scales), pad_val=PAD_VALUE).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_rot_scale_matches_on_jax_draws(seed):
    """Arbitrary angles and scales drawn by jax.random: within 1e-4 (the
    shear lerps differ by an f32 ulp where XLA contracts them into an
    FMA, and cos/tan by an ulp between the libraries; the separable
    scales carry those through)."""
    imgs = smooth_batch(4, 48, seed)
    angles, scales, _, _ = jax_draws(jax.random.PRNGKey(seed), 4)
    ref = np.asarray(jaug._rot_scale_sample_batch(
        jnp.asarray(imgs), jnp.asarray(angles.numpy()),
        jnp.asarray(scales.numpy()), pad_val=PAD_VALUE))
    got = taug._rot_scale_sample_batch(torch.from_numpy(imgs), angles,
                                       scales, pad_val=PAD_VALUE).numpy()
    assert np.abs(got - ref).max() <= 1e-4


@pytest.mark.parametrize("shape", [(4, 64, 64), (2, 32, 48)])
def test_augment_batch_matches_jax(shape):
    """augment_batch on the reference's draws: images within 1e-4, boxes
    within 1e-4 px (f32 sin/cos of either library), masks equal.  Square
    batches take the shear decomposition, non-square the gather."""
    b, h, w = shape
    rng = np.random.default_rng(3)
    imgs = smooth_batch(b, max(h, w))[:, :h, :w]
    m = 4
    xy = rng.random((b, m, 2)) * (min(h, w) - 20) + 2
    boxes = np.concatenate([xy, xy + rng.uniform(3, 16, (b, m, 2))],
                           -1).astype(np.float32)
    boxes[0, 0] = [w - 4.0, h - 4.0, w - 1.0, h - 2.0]   # tiny: may drop
    masks = np.ones((b, m), bool)
    masks[1, 3] = False
    key = jax.random.PRNGKey(11)
    ri, rb, rm = (np.asarray(t) for t in jaug.augment_batch(
        key, jnp.asarray(imgs), jnp.asarray(boxes), jnp.asarray(masks)))
    gi, gb, gm = taug.augment_batch(
        torch.from_numpy(np.ascontiguousarray(imgs)), torch.from_numpy(boxes),
        torch.from_numpy(masks), *jax_draws(key, b))
    assert np.abs(gi.numpy() - ri).max() <= 1e-4
    np.testing.assert_allclose(gb.numpy(), rb, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(gm.numpy(), rm)


def test_draws_follow_the_reference_distributions():
    """The port's own draws (torch.Generator) are reproducible from the
    generator's seed and lie in the reference's ranges; flips are about
    half."""
    a = taug.draw_augment_params(torch.Generator().manual_seed(5), 4000)
    b = taug.draw_augment_params(torch.Generator().manual_seed(5), 4000)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    angles, scales, ud, lr = a
    assert angles.abs().max() <= math.pi and angles.abs().max() > 3.0
    assert scales.min() >= 0.11 and scales.max() <= 1.89
    for flips in (ud, lr):
        assert 0.45 < flips.float().mean() < 0.55
