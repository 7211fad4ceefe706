"""The PyTorch port's zscale and README preprocessing chain (K3's plain
version) against the JAX package, on the CPU with the same seeded
inputs."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caesar_yolo_tpu.ops.pallas_preproc as jax_pallas_preproc
from caesar_yolo_tpu.ops import build_preprocessor as jax_build_preprocessor
from caesar_yolo_tpu.ops.zscale import zscale_limits as jax_zscale_limits
from caesar_yolo_tpu_torch.ops import cuda_preproc
from caesar_yolo_tpu_torch.ops.transforms import (
    Pipeline,
    build_preprocessor,
    min_max_normalizer,
    prepare_tiles,
    zscale_transformer,
)
from caesar_yolo_tpu_torch.ops.zscale import zscale_limits

torch.set_num_threads(1)

# The zscale line fit sums in f32 in another order than XLA's, which
# moves (vmin, vmax) by f32 rounding; after the stretch and min-max that
# stays below 1e-5 on [0, 1] outputs.
ATOL = 1e-5


def _tiles(seed, b=6, size=48, c=1):
    """Noise + a bright source per tile, with masked (zero) pixels, one
    all-zero tile, one tile holding NaNs on sampled pixels, one constant
    tile and one tile holding a NaN only off the zscale sample grid."""
    rng = np.random.default_rng(seed)
    t = rng.normal(0.0, 1.0, (b, size, size, c)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    t += (8.0 * np.exp(-((xx - 20) ** 2 + (yy - 25) ** 2) / 18.0)
          ).astype(np.float32)[None, :, :, None]
    t[:, 3:7, 5:11] = 0.0
    t[1] = 0.0
    t[2, 0, 0] = np.nan               # sample 0 of the zscale grid
    t[3] = 2.5
    t[4, 0, 1] = np.nan               # off the stride-2 sample grid
    return t


def test_zscale_limits_match_jax():
    t = _tiles(0)[..., 0]
    t[2] = np.nan_to_num(t[2])        # the reference needs finite input
    vmin, vmax = zscale_limits(torch.from_numpy(t))
    for i in range(len(t)):
        jmin, jmax = jax_zscale_limits(jnp.asarray(t[i]))
        np.testing.assert_allclose([vmin[i].item(), vmax[i].item()],
                                   [float(jmin), float(jmax)],
                                   rtol=2e-6, atol=1e-6)


def test_plain_matches_pallas_interpret(monkeypatch):
    """K3's plain version against fused_zscale_minmax in interpret mode."""
    monkeypatch.setattr(jax_pallas_preproc, "INTERPRET", True)
    t = _tiles(1)[..., 0]
    ref, rvalid = jax_pallas_preproc.fused_zscale_minmax(jnp.asarray(t))
    out, valid = cuda_preproc.fused_zscale_minmax(torch.from_numpy(t))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    assert valid.numpy().tolist() == [True, False, False, False, True, True]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("norm", [(0.0, 1.0), (-1.0, 255.0)])
def test_pipeline_matches_jax_apply_batch(c, norm):
    """The port's README pipeline (the fused path) and the same stages run
    one by one against the reference's Pipeline.apply_batch on 1- and
    3-channel tiles with zero, NaN and constant tiles."""
    t = _tiles(2 + c, c=c)
    if c == 3:
        t[5, ..., 1] *= 3.0           # channels that differ
    kw = dict(zscale_stretch=True, normalize_minmax=True,
              norm_min=norm[0], norm_max=norm[1])
    ref, rvalid = jax_build_preprocessor(**kw).apply_batch(jnp.asarray(t))
    pipe = build_preprocessor(**kw)
    assert pipe.fused is not None
    staged = Pipeline([zscale_transformer(), min_max_normalizer(*norm)])
    for p in (pipe, staged):
        out, valid = p.apply_batch(torch.from_numpy(t))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=ATOL * (norm[1] - norm[0]), rtol=0)


def test_single_stage_pipelines_match_jax():
    t = _tiles(9)
    for kw in (dict(zscale_stretch=True), dict(normalize_minmax=True)):
        ref, rvalid = jax_build_preprocessor(**kw).apply_batch(
            jnp.asarray(t))
        out, valid = build_preprocessor(**kw).apply_batch(
            torch.from_numpy(t))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
        np.testing.assert_allclose(np.nan_to_num(out.numpy(), nan=7.0),
                                   np.nan_to_num(np.asarray(ref), nan=7.0),
                                   atol=ATOL, rtol=0)


def test_gray_preprocessed_once_equals_repeat_first():
    """The engine may run the channel-uniform README chain on the gray
    plane and repeat it after: bit-identical to repeating first, as the
    reference does (engine.py:57-58)."""
    t = torch.from_numpy(_tiles(4))
    pipe = build_preprocessor(zscale_stretch=True, normalize_minmax=True)
    assert pipe.channel_uniform
    once, ok_once = prepare_tiles(t, pipe, 3)
    first, ok_first = prepare_tiles(t.expand(-1, -1, -1, 3).contiguous(),
                                    pipe, 3)
    assert torch.equal(once, first)
    assert torch.equal(ok_once, ok_first)
    assert ok_once.tolist() == [True, False, False, False, True, True]


# The stages of the full chain (bkg, clips, chan3) against the reference's
# Pipeline.apply_batch (its .batch paths, i.e. the Pallas K5/K6 kernels in
# interpret mode).  Their statistics are f32 sums in another order, so a
# background level or clip bound may move by f32 rounding; a pixel next to
# a histogram bin edge can then change bin.  Rule: valid flags equal, and
# at most 0.2% of the outputs further than ATOL (scaled to the output
# range) from the reference.
STAGE_CASES = {
    "bkg": dict(subtract_bkg=True),
    "bkg_box": dict(subtract_bkg=True, use_box_mask_in_bkg=True,
                    bkg_box_mask_fract=0.5),
    "bkg_chid": dict(subtract_bkg=True, bkg_chid=1),
    "clip_shift": dict(clip_shift_data=True, sigma_clip=1.5),
    "clip": dict(clip_data=True, sigma_clip_low=2.0, sigma_clip_up=3.0),
    "clip_chid": dict(clip_data=True, clip_chid=0, sigma_clip_low=1.0),
    "chan3": dict(chan3_preproc=True),
    "bkg_chan3_minmax": dict(subtract_bkg=True, chan3_preproc=True,
                             sigma_clip_low=1.0, sigma_clip_up=20.0,
                             normalize_minmax=True, norm_max=255.0),
    "nchannels3": dict(nchannels=3, zscale_stretch=True,
                       normalize_minmax=True),
}


def _stage_tiles(seed, c):
    """_tiles with a brighter source (so clipping bites) and NaNs on
    source pixels of tile 2, which the chan3 chain without bkg keeps
    until the clip and hist-eq stages."""
    t = _tiles(seed, c=c)
    yy, xx = np.mgrid[0:48, 0:48]
    t += (60.0 * np.exp(-((xx - 30) ** 2 + (yy - 12) ** 2) / 8.0)
          ).astype(np.float32)[None, :, :, None]
    t[2, 28:31, 18:22] = np.nan
    t[1] = 0.0
    t[3] = 2.5
    return t


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("case", list(STAGE_CASES))
def test_stages_match_jax_apply_batch(case, c):
    kw = STAGE_CASES[case]
    t = _stage_tiles(20 + c, c)
    if c == 3:
        t[..., 1] *= 3.0
    ref, rvalid = jax_build_preprocessor(**kw).apply_batch(jnp.asarray(t))
    pipe = build_preprocessor(**kw)
    out, valid = pipe.apply_batch(torch.from_numpy(t))
    ref = np.asarray(ref)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rvalid))
    assert out.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(ref))
    scale = max(1.0, float(np.nanmax(np.abs(ref))))
    diff = np.abs(np.nan_to_num(out.numpy()) - np.nan_to_num(ref))
    assert (diff > ATOL * scale).mean() <= 2e-3, (case, diff.max())


@pytest.mark.parametrize("case", ["bkg_chan3_minmax", "bkg", "chan3"])
def test_full_chain_gray_once_equals_repeat_first(case):
    """Gray tiles run the chain on their one plane (the chan3 stage makes
    the three channels); bit-identical to repeating to 3 channels first,
    as the reference does."""
    t = torch.from_numpy(_stage_tiles(7, 1))
    pipe = build_preprocessor(**STAGE_CASES[case])
    assert pipe.channel_uniform
    once, ok_once = prepare_tiles(t, pipe, 3)
    first, ok_first = prepare_tiles(t.expand(-1, -1, -1, 3).contiguous(),
                                    pipe, 3)
    assert torch.equal(once.nan_to_num(), first.nan_to_num())
    assert torch.equal(ok_once, ok_first)
    assert not build_preprocessor(**STAGE_CASES["bkg_chid"]).channel_uniform


def test_unported_stages_raise(tmp_path, monkeypatch):
    """Every preprocessing flag now builds its stage, and no CLI flag is
    refused: --datalist is ported (a missing filelist is an argument
    error), --draw_plots --save_plots write the plot of a run through the
    whole chain, and --int8 calibrates through it."""
    from caesar_yolo_tpu_torch.cli.run import main

    pipe = build_preprocessor(subtract_bkg=True, clip_shift_data=True,
                              clip_data=True, nchannels=3,
                              zscale_stretch=True, chan3_preproc=True,
                              normalize_minmax=True)
    assert len(pipe.stages) == 7
    argv = [f"--image={tmp_path / 'x.fits'}", "--weights=w.npz",
            "--devices=cpu"]
    assert main([*argv, f"--datalist={tmp_path / 'l.txt'}"]) == 1
    # --int8 is ported: it calibrates through the preprocessing chain
    from caesar_yolo_tpu_torch.utils.fits import write_fits
    rng = np.random.default_rng(4)
    img = rng.normal(0, 0.1, (96, 96)).astype(np.float32)
    yy, xx = np.mgrid[0:96, 0:96]
    for cx, cy in ((30, 40), (70, 62)):
        img += 5.0 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 40.0)
    write_fits(img.astype(np.float32), str(tmp_path / "x.fits"))
    weights = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "yolov8n_synth96.npz")
    chain = [f"--image={tmp_path / 'x.fits'}", f"--weights={weights}",
             "--devices=cpu", "--imgsize=96", "--preprocessing",
             "--subtract_bkg", "--chan3_preproc", "--sigma_clip_baseline=0",
             "--sigma_clip_low=1", "--sigma_clip_up=20", "--normalize_minmax"]
    assert main([*chain, "--int8",
                 f"--detect_outfile_json={tmp_path / 'c.json'}",
                 f"--detect_outfile={tmp_path / 'c.reg'}"]) == 0
    assert (tmp_path / "c.json").exists()
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)
    assert main([*chain, "--draw_plots", "--save_plots"]) == 0
    with open(tmp_path / "out_x.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
