"""The port's preprocessing factories that no CLI flag reaches (scalers,
shifters, stretches, border mask, resizer, channel divider, global and
adaptive histogram equalisation) against the JAX package's, on the CPU
with the same seeded masked inputs: each stage's batch path on gray and
3-channel tiles, the engine's gray-tile preparation (the port's one-plane
route where the chain allows it against the reference's repeat-first),
and a chain of them through the port's TileEngine against the JAX
TileEngine."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_yolo_tpu.models.convert import load_params
from caesar_yolo_tpu.models.yolo import build_model as jax_build_model
from caesar_yolo_tpu.ops import transforms as jt
from caesar_yolo_tpu.parallel.engine import TileEngine as JaxTileEngine
from caesar_yolo_tpu_torch.models.convert import load_model
from caesar_yolo_tpu_torch.ops import transforms as tt
from caesar_yolo_tpu_torch.parallel.engine import TileEngine
from caesar_yolo_tpu_torch.utils.boxes import catalog_mismatch

torch.set_num_threads(1)

WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "yolov8n_synth96.npz")

# (factory name, kwargs); every factory the CLI does not build
CASES = {
    "abs_minmax": ("abs_min_max_normalizer", {}),
    "abs_minmax_255": ("abs_min_max_normalizer",
                       dict(norm_min=-1.0, norm_max=255.0)),
    "max_scaler": ("max_scaler", {}),
    "abs_max": ("abs_max_scaler", {}),
    "abs_max_box": ("abs_max_scaler", dict(use_mask_box=True,
                                           mask_fract=0.5)),
    "chan_max": ("chan_max_scaler", {}),
    "chan_max_box": ("chan_max_scaler", dict(chref=1, use_mask_box=True,
                                             mask_fract=0.6)),
    "scaler": ("scaler", dict(scale_factors=[2.0, 0.5, 3.0])),
    "scaler_equal": ("scaler", dict(scale_factors=[1.5, 1.5, 1.5])),
    "min_shifter": ("min_shifter", {}),
    "min_shifter_chid": ("min_shifter", dict(chid=1)),
    "shifter": ("shifter", dict(offsets=[0.1, -0.2, 0.3])),
    "shifter_equal": ("shifter", dict(offsets=[0.25, 0.25, 0.25])),
    "standardizer": ("standardizer", dict(means=[0.1, 0.2, 0.3],
                                          sigmas=[2.0, 3.0, 4.0])),
    "negative_fixer": ("negative_data_fixer", {}),
    "log": ("log_stretcher", {}),
    "log_minmax": ("log_stretcher", dict(minmaxnorm=True)),
    "log_chid_clip": ("log_stretcher", dict(chid=1, minmaxnorm=True,
                                            clip_neg=True,
                                            data_norm_min=-2.0,
                                            data_norm_max=1.0)),
    "border": ("border_masker", dict(mask_fract=0.6)),
    "resize_pad": ("resizer", dict(resize_size=64)),
    "resize_up": ("resizer", dict(resize_size=72, upscale=True)),
    "resize_down": ("resizer", dict(resize_size=30)),
    "resize_nomin": ("resizer", dict(resize_size=40,
                                     set_pad_val_to_min=False)),
    "divider": ("chan_divider", {}),
    "divider_log": ("chan_divider", dict(chref=1, logtransf=True, trim=True,
                                         trim_min=-1.0, trim_max=0.5)),
    "divider_strip": ("chan_divider", dict(logtransf=True,
                                           strip_chref=True)),
    "histeq": ("hist_equalizer", {}),
    "clahe": ("hist_equalizer", dict(adaptive=True)),
    "clahe_001": ("hist_equalizer", dict(adaptive=True, clip_limit=0.01)),
}

# Cross-channel stages, marked not channel-uniform (a gray tile repeats to
# 3 channels before them); with unequal per-channel values so are the
# scaler, shifter and standardizer, and with chid != -1 the min shifter and
# the log stretch.
NOT_UNIFORM = {"abs_minmax", "abs_minmax_255", "abs_max", "abs_max_box",
               "chan_max", "chan_max_box", "scaler", "shifter",
               "standardizer", "min_shifter_chid", "log_chid_clip",
               "divider", "divider_log", "divider_strip"}

# Tolerance, relative to the output's largest magnitude: the stages are
# the same f32 operations in the same order, but log10 and the antialiased
# resize may round one ulp apart between XLA and PyTorch, and CLAHE's
# redistribution sums and CDF cumsum run in another order (4.2e-7 on
# [0, 1] outputs against the XLA and the Pallas form, tests/
# test_torch_clahe.py).
RTOL = 2e-6


def _make(lib, case):
    name, kw = CASES[case]
    return getattr(lib, name)(**kw)


def _tiles(seed, c, b=5, size=48):
    """Noise with a bright source, negative pixels, a masked (zero) block,
    a NaN, an all-zero tile and a constant tile."""
    rng = np.random.default_rng(seed)
    t = rng.normal(0.5, 1.0, (b, size, size, c)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    t += (20.0 * np.exp(-((xx - 30) ** 2 + (yy - 15) ** 2) / 10.0)
          ).astype(np.float32)[None, :, :, None]
    if c > 1:
        t[..., 1] *= 2.0
    t[:, 3:7, 5:11] = 0.0
    t[0, 40, 41] = np.nan
    t[1] = 0.0
    t[3] = 2.5
    return t


def _compare(got, ref, gvalid, rvalid, case):
    ref = np.asarray(ref)
    got = got.numpy()
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(rvalid),
                                  err_msg=case)
    assert got.shape == ref.shape, case
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=case)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(ref), err_msg=case)
    fin = np.isfinite(ref)
    scale = max(1.0, float(np.abs(ref[fin]).max(initial=0.0)))
    np.testing.assert_allclose(got[fin], ref[fin], atol=RTOL * scale, rtol=0,
                               err_msg=case)


@pytest.mark.parametrize("case", list(CASES))
def test_stage_matches_jax_apply_batch(case):
    """The stage on 3-channel tiles (and on gray ones where the reference
    takes them) against the reference's Pipeline.apply_batch (CLAHE
    against its XLA form; tests/test_torch_clahe.py holds it to the Pallas
    form too)."""
    name = CASES[case][0]
    for c in (3, 1):
        if c == 1 and case in ("scaler", "shifter", "standardizer",
                               "chan_max_box", "divider", "divider_log",
                               "divider_strip", "min_shifter_chid",
                               "log_chid_clip", "scaler_equal",
                               "shifter_equal"):
            continue                       # per-channel values or a chref
        t = _tiles(7 + c, c)
        ref, rvalid = jt.Pipeline([_make(jt, case)]).apply_batch(
            jnp.asarray(t), native=not case.startswith("clahe"))
        got, gvalid = tt.Pipeline([_make(tt, case)]).apply_batch(
            torch.from_numpy(t))
        _compare(got, ref, gvalid, rvalid, f"{case} c={c} ({name})")


def _jax_prep(pipe, tiles, nchan=3, native=True):
    """The reference engine's preparation (engine.py:55-73): repeat gray to
    nchan, apply_batch, the degenerate-channel guard."""
    x = jnp.asarray(tiles)
    if x.shape[-1] == 1 and nchan > 1:
        x = jnp.repeat(x, nchan, axis=-1)
    imgs, ok = pipe.apply_batch(x, native=native)
    if imgs.shape[-1] == 1 and nchan > 1:
        imgs = jnp.repeat(imgs, nchan, axis=-1)
    ok = ok & jnp.all(jnp.max(imgs, axis=(1, 2)) > jnp.min(imgs, axis=(1, 2)),
                      axis=-1)
    return imgs, ok


@pytest.mark.parametrize("case", list(CASES))
def test_gray_tile_preparation_matches_jax(case):
    """prepare_tiles on gray tiles (the one-plane route when the stage is
    channel-uniform) against the reference's repeat-first preparation, with
    the uniform flags of NOT_UNIFORM.  CLAHE is held to the XLA form here:
    the degenerate-channel guard sees the constant tile, which the XLA form
    and the port leave constant and the Pallas form does not
    (tests/test_torch_clahe.py:test_constant_tile_is_degenerate)."""
    stage = _make(tt, case)
    assert stage.uniform == (case not in NOT_UNIFORM), case
    t = _tiles(11, 1)
    ref, rok = _jax_prep(jt.Pipeline([_make(jt, case)]), t,
                         native=not case.startswith("clahe"))
    got, gok = tt.prepare_tiles(torch.from_numpy(t),
                                tt.Pipeline([stage]), 3)
    _compare(got, ref, gok, rok, case)


def test_chain_through_tile_engine_matches_jax():
    """Gray tiles through a chain of the new stages (log stretch, border
    mask, per-channel max scale, then the cross-channel abs min-max, so the
    port repeats to 3 channels first) in the port's TileEngine against the
    JAX TileEngine in f32, by the catalog rule (the CLAHE stage runs
    through both engines in tests/test_torch_eval_golden.py)."""
    from caesar_yolo_tpu_torch.utils.synth import make_mosaic
    tiles = np.stack([make_mosaic(96, 96, n_sources=3, noise_sigma=0.08,
                                  seed=40 + i, amp_range=(3.0, 8.0),
                                  sigma_range=(2.5, 5.0))[0] + 0.5
                      for i in range(4)])[..., None].astype(np.float32)
    tiles[2] = 0.0
    tiles[0, :, :3] = 0.0                          # masked columns
    stages = [("log_stretcher", dict(minmaxnorm=True, data_norm_min=-1.0,
                                     data_norm_max=1.5)),
              ("border_masker", dict(mask_fract=0.9)),
              ("max_scaler", {}),
              ("abs_min_max_normalizer", {})]
    kw = dict(img_size=96, score_thr=0.2, iou_thr=0.5)
    params, meta = load_params(WEIGHTS)
    jm = jax_build_model(meta["model"], num_classes=int(meta["num_classes"]))
    ref = JaxTileEngine(
        jm, params, compute_dtype=jnp.float32,
        preprocessor=jt.Pipeline([getattr(jt, n)(**k) for n, k in stages]),
        **kw).process(tiles)
    pipe = tt.Pipeline([getattr(tt, n)(**k) for n, k in stages])
    assert not pipe.channel_uniform
    got = TileEngine(load_model(WEIGHTS)[0], device="cpu",
                     compute_dtype=torch.float32, preprocessor=pipe,
                     **kw).process(tiles)
    rb, rs, rc, rv, rok, rdrop = (np.asarray(r) for r in ref)
    gb, gs, gc, gv, gok, gdrop = got
    np.testing.assert_array_equal(gok, rok)
    assert rok.tolist() == [True, True, False, True]
    np.testing.assert_array_equal(gdrop, rdrop)
    assert rv.sum() >= 3
    for i in range(len(tiles)):
        assert catalog_mismatch((rb[i][rv[i]], rs[i][rv[i]], rc[i][rv[i]]),
                                (gb[i][gv[i]], gs[i][gv[i]], gc[i][gv[i]])
                                ) is None, i


def test_per_channel_values_must_fit_the_channels():
    with pytest.raises(ValueError):
        tt.scaler([1.0, 2.0])(torch.ones(1, 4, 4, 3))
    with pytest.raises(ValueError):
        tt.standardizer([0.0, 1.0], [1.0])


def _unletterbox_host_constants(boxes, h, w, img_size):
    """unletterbox_boxes with its constants built on the host, as it was
    before it filled them on the device."""
    from caesar_yolo_tpu_torch.detect.letterbox import letterbox_geometry
    r, _, _, top, left = letterbox_geometry(h, w, img_size)
    shift = torch.tensor([left, top, left, top], dtype=boxes.dtype)
    lim = torch.tensor([w, h, w, h], dtype=boxes.dtype)
    return torch.minimum(((boxes - shift) / r).clamp(min=0.0), lim)


@pytest.mark.parametrize("h,w,img_size", [
    (512, 512, 640), (512, 256, 640), (256, 512, 640), (96, 96, 96),
    (100, 37, 96), (37, 100, 96), (640, 300, 320), (1, 513, 640)])
def test_unletterbox_boxes_equals_host_constants_bit_for_bit(h, w, img_size):
    from caesar_yolo_tpu_torch.detect.letterbox import unletterbox_boxes
    g = torch.Generator().manual_seed(h * 1009 + w)
    boxes = torch.rand((3, 40, 4), generator=g) * 1.4 * img_size - 0.2 * (
        img_size)
    boxes[0, :3, 1] = torch.tensor([float("nan"), float("inf"),
                                    -float("inf")])
    got = unletterbox_boxes(boxes, h, w, img_size)
    ref = _unletterbox_host_constants(boxes, h, w, img_size)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def _per_channel_list_index(data, chid, fn, skip=False):
    """transforms._per_channel as it was, with a list index."""
    b, c = data.shape[0], data.shape[-1]
    chans = [i for i in range(c)
             if chid == -1 or (i != chid if skip else i == chid)]
    valid = torch.ones(b, dtype=torch.bool)
    if not chans:
        return data, valid
    out, ok = fn(tt._planes(data[..., chans]))
    valid = valid & ok.reshape(b, -1).all(dim=1)
    if len(chans) == c:
        return tt._unplanes(out, b), valid
    data = data.clone()
    data[..., chans] = tt._unplanes(out, b)
    return data, valid


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("chid", [-1, 0, 1, 3])
@pytest.mark.parametrize("factory", ["min_shifter", "log_stretcher",
                                     "bkg_subtractor"])
def test_per_channel_slices_equal_the_list_index(monkeypatch, factory, chid,
                                                 channels):
    """The channel subsets _per_channel takes by slices (one channel, all,
    all but one in one or two runs, none) give the list index's bits;
    log_stretcher's chid names the channel to skip."""
    stage = getattr(tt, factory)(chid=chid)
    g = torch.Generator().manual_seed(17 * channels + chid)
    data = torch.rand((3, 20, 24, channels), generator=g) * 4.0 - 1.0
    data[0, :4, :5] = 0.0
    data[1, 2, 3] = float("nan")
    data[2, ..., -1] = 0.0          # an empty last channel
    got, got_ok = stage(data)
    monkeypatch.setattr(tt, "_per_channel", _per_channel_list_index)
    ref, ref_ok = stage(data)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert torch.equal(got_ok, ref_ok)
