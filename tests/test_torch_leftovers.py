"""The port's last host-side modules against the JAX package on the CPU:
`detect/nms.py`'s nms_single and nms_batch_raw, `utils/resize.py`,
`utils/misc.py`, `outputs/plot.py` and `utils/fits_native.py`.

Tolerances: NMS keep masks, classes and n_dropped exactly equal; boxes
and scores bit for bit in nms_single; in nms_batch_raw within 1e-4 of
JAX's (the DFL softmax's exp differs between XLA and PyTorch by ulps: 3e-5
px on boxes of 100-200 px) and of the port's composed
nms_batch(*decode_dfl(raw)) (on the CPU PyTorch's vectorised sigmoid may
round a value of the window and the same value of the whole array one ulp
apart); resize and misc outputs exactly equal; the native reader equal to
`read_fits_crop` bit for bit.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_yolo_tpu.detect.nms import nms_batch_raw as jax_nms_batch_raw
from caesar_yolo_tpu.detect.nms import nms_single as jax_nms_single
from caesar_yolo_tpu.models.yolo import REG_MAX
from caesar_yolo_tpu.utils import misc as jax_misc
from caesar_yolo_tpu.utils import resize as jax_resize
from caesar_yolo_tpu_torch.detect.nms import (
    nms_batch,
    nms_batch_raw,
    nms_single,
)
from caesar_yolo_tpu_torch.models.yolo import decode_dfl
from caesar_yolo_tpu_torch.utils import fits_native, misc, resize
from caesar_yolo_tpu_torch.utils.fits import read_fits_crop, write_fits

NAMES = ("boxes", "scores", "cls", "valid", "n_dropped")


def _scores(n, pairs):
    s = np.zeros((n, 5), np.float32)
    for i, (c, v) in enumerate(pairs):
        s[i, c] = v
    return s


def _boxes(rows):
    return np.asarray(rows, np.float32)


# the cases of tests/test_detect.py's nms_single tests
NMS_SINGLE_CASES = {
    "suppresses_overlaps": (
        _boxes([[0, 0, 10, 10], [1, 1, 10, 10], [20, 20, 30, 30]]),
        _scores(3, [(1, 0.9), (1, 0.8), (2, 0.7)]),
        dict(conf_thr=0.25, iou_thr=0.5, max_det=8, pre_nms=3), 2),
    "class_aware": (
        _boxes([[0, 0, 10, 10], [0, 0, 10, 10]]),
        _scores(2, [(1, 0.9), (2, 0.8)]),
        dict(conf_thr=0.25, iou_thr=0.5, max_det=8, pre_nms=2), 2),
    "class_agnostic": (
        _boxes([[0, 0, 10, 10], [0, 0, 10, 10]]),
        _scores(2, [(1, 0.9), (2, 0.8)]),
        dict(conf_thr=0.25, iou_thr=0.5, max_det=8, pre_nms=2,
             class_agnostic=True), 1),
    "conf_threshold_and_maxdet": (
        _boxes([[i * 20, 0, i * 20 + 10, 10] for i in range(6)]),
        _scores(6, [(0, 0.9), (1, 0.8), (2, 0.7), (3, 0.6), (4, 0.5),
                    (0, 0.1)]),
        dict(conf_thr=0.45, iou_thr=0.5, max_det=3, pre_nms=6), 3),
    "descending_and_padded": (
        _boxes([[0, 0, 10, 10]]), _scores(1, [(3, 0.6)]),
        dict(conf_thr=0.25, iou_thr=0.5, max_det=4, pre_nms=1), 1),
    "window_truncation": (
        _boxes([[i * 20, 0, i * 20 + 10, 10] for i in range(6)]),
        _scores(6, [(0, 0.9), (1, 0.8), (2, 0.7), (3, 0.6), (4, 0.5),
                    (0, 0.4)]),
        dict(conf_thr=0.3, iou_thr=0.5, max_det=8, pre_nms=4), 4),
}


def _equal(ref, got, atol=0.0):
    """Keep masks, classes and n_dropped equal; boxes and scores within
    atol (0: equal)."""
    for name, r, g in zip(NAMES, ref, got):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        r = np.asarray(r)
        assert r.dtype == g.dtype, name
        if atol and name in ("boxes", "scores"):
            np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.parametrize("case", sorted(NMS_SINGLE_CASES))
def test_nms_single_matches_jax(case):
    boxes, scores, kw, n_kept = NMS_SINGLE_CASES[case]
    ref = jax_nms_single(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    got = nms_single(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    assert got[0].shape == (kw["max_det"], 4) and got[4].shape == ()
    assert int(got[3].sum()) == n_kept
    _equal(ref, got)


def _raw(rng, size, nc, b, dtype):
    """Seeded head outputs: JAX's layout (per level [B, h, w, 4*REG_MAX]
    and [B, h, w, NC]) and the port's (NCHW) of the same values."""
    jraw, traw = [], []
    for stride in (8, 16, 32):
        n = size // stride
        box = rng.normal(0, 2, (b, n, n, 4 * REG_MAX)).astype(np.float32)
        cls = rng.normal(-2, 2.5, (b, n, n, nc)).astype(np.float32)
        jraw.append((jnp.asarray(box).astype(dtype),
                     jnp.asarray(cls).astype(dtype)))
        traw.append(tuple(
            torch.from_numpy(np.array(a.astype(jnp.float32))).permute(
                0, 3, 1, 2).to(getattr(torch, jnp.dtype(dtype).name))
            for a in jraw[-1]))
    return tuple(jraw), traw


@pytest.mark.parametrize("conf_thr,pre_nms,agnostic,dtype", [
    (0.25, 32, False, jnp.float32), (0.5, 16, True, jnp.float32),
    (0.7, 8, False, jnp.float32), (0.3, 16, False, jnp.bfloat16),
    (0.0, 20, False, jnp.float32)])
def test_nms_batch_raw_matches_jax_and_composed(conf_thr, pre_nms, agnostic,
                                                dtype):
    """The fused logit-space path against JAX's (the cases of
    tests/test_detect.py's raw tests, plus a zero threshold) and against
    the port's own decode_dfl -> nms_batch."""
    size = 64 if dtype == jnp.float32 else 32
    jraw, traw = _raw(np.random.default_rng(42), size, 5, 3, dtype)
    kw = dict(conf_thr=conf_thr, iou_thr=0.5, max_det=20, pre_nms=pre_nms,
              class_agnostic=agnostic)
    got = nms_batch_raw(traw, size, **kw)
    _equal(jax_nms_batch_raw(jraw, size, **kw), got, atol=1e-4)
    _equal([t.numpy() for t in nms_batch(*decode_dfl(traw, size), **kw)],
           got, atol=1e-4)
    assert got[3].any()


def test_resize_img_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.random((40, 60, 3), np.float32)
    mask = (np.arange(16).reshape(4, 4) % 3).astype(np.uint8)
    for args, kw in (((img, (80, 120)), {}), ((img, (40, 60)), {}),
                     ((img, (17, 33)), {}), ((img[..., 0], (25, 90)), {}),
                     ((mask, (8, 8)), {"order": 0})):
        got = resize.resize_img(*args, **kw)
        ref = jax_resize.resize_img(*args, **kw)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("image,kw", [
    (np.ones((50, 100), np.float32), dict(min_dim=64, max_dim=128,
                                          mode="square")),
    (np.ones((10, 12), np.float32), dict(mode="none")),
    (np.ones((100, 130, 3), np.float32), dict(mode="pad64")),
    (np.arange(100 * 100, dtype=np.float32).reshape(100, 100),
     dict(min_dim=64, mode="crop")),
    (np.ones((4, 4)), dict(mode="bogus")),
    (np.ones((4, 4, 3, 1)), dict(mode="square", max_dim=8)),
    (np.zeros((8, 8), np.float32), dict(min_dim=16)),
])
def test_resize_img_v2_and_mask_match_jax(image, kw):
    """resize_img_v2 (every mode, the invalid inputs) and resize_mask of
    its transform, against the JAX package's (crop mode on equal seeds)."""
    if kw.get("mode") == "crop":
        kw = dict(kw, rng=None)
        got = resize.resize_img_v2(image, **{**kw, "rng":
                                             np.random.default_rng(7)})
        ref = jax_resize.resize_img_v2(image, **{**kw, "rng":
                                                 np.random.default_rng(7)})
    else:
        got = resize.resize_img_v2(image, **kw)
        ref = jax_resize.resize_img_v2(image, **kw)
    if ref is None:
        assert got is None
        return
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1:] == ref[1:]
    mask = np.zeros(image.shape[:2], np.uint8)
    mask[2:7, 3:9] = 1
    np.testing.assert_array_equal(resize.resize_mask(mask, *got[2:]),
                                  jax_resize.resize_mask(mask, *ref[2:]))


def test_misc_matches_jax(tmp_path):
    """The twin of tests/test_aux.py::test_misc_utils, each function
    against the JAX package's."""
    f = tmp_path / "list.txt"
    f.write_text("a.fits\n\nb.fits\n")
    assert misc.read_filelist(str(f)) == jax_misc.read_filelist(str(f)) == [
        "a.fits", "b.fits"]
    t = tmp_path / "t.dat"
    t.write_text("# hdr\n1 2 3\n4 5 6\n")
    np.testing.assert_array_equal(misc.read_table(str(t)),
                                  jax_misc.read_table(str(t)))
    mask = np.zeros((4, 4))
    mask[1, 1] = 1
    out = misc.apply_mask(np.zeros((4, 4, 3), np.float32), mask,
                          (1.0, 0, 0), alpha=0.5)
    np.testing.assert_array_equal(out, jax_misc.apply_mask(
        np.zeros((4, 4, 3), np.float32), mask, (1.0, 0, 0), alpha=0.5))
    assert out[1, 1, 0] == 127.5
    for x in (np.asarray([[0.0, 1.0], [3.0, np.nan]], np.float32),
              np.zeros((3, 3), np.float32)):
        np.testing.assert_array_equal(misc.to_uint8(x.copy()),
                                      jax_misc.to_uint8(x.copy()))
    fns = (lambda v: v + 1, lambda v: v * 2)
    assert misc.compose_fcns(*fns)(3) == jax_misc.compose_fcns(*fns)(3) == 7
    for s in ("float64", "int64", "uint8", "float32"):
        assert misc.set_type(s) == jax_misc.set_type(s)


def test_draw_results_writes_png(tmp_path):
    """outputs/plot.py: a plot of class-coloured boxes, saved as PNG for
    gray, [0, 1] RGB and 0-255 images."""
    pytest.importorskip("matplotlib")
    from caesar_yolo_tpu_torch.outputs.plot import draw_results
    objs = [{"x1": 4.0, "y1": 5.0, "x2": 20.0, "y2": 30.0,
             "class_name": "compact", "score": 0.9},
            {"x1": 30.0, "y1": 2.0, "x2": 40.0, "y2": 12.0,
             "class_name": "extended", "score": 0.5}]
    rng = np.random.default_rng(3)
    for i, (img, caption) in enumerate((
            (rng.random((48, 48)), True),
            (rng.random((48, 48, 3)), False),
            (rng.random((48, 48, 3)) * 300, True))):
        out = tmp_path / f"p{i}.png"
        draw_results(img, objs, str(out), draw_class_label_in_caption=caption)
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_fits_native_matches_read_fits_crop(tmp_path):
    """The port's ctypes wrapper over native/libcytfits.so reads the same
    windows as utils/fits.read_fits_crop, bit for bit; an out-of-bounds
    window gives None."""
    if not fits_native.available():
        pytest.skip("the native FITS reader could not be built")
    rng = np.random.default_rng(5)
    data = rng.normal(size=(70, 90)).astype(np.float32)
    data[3, 4] = np.nan                       # NaN -> 0 in both readers
    path = str(tmp_path / "m.fits")
    write_fits(data, path)
    assert fits_native.fits_info(path)[1:] == (-32, 90, 70)
    wins = [[10, 74, 20, 60], [0, 90, 0, 70], [60, 90, 0, 32]]
    tiles = fits_native.read_tiles_batch(path, wins)
    for (x0, x1, y0, y1), tile in zip(wins, tiles):
        ref = read_fits_crop(path, x0, x1, y0, y1)[0]
        assert tile.dtype == np.float32 and tile.shape == ref.shape
        np.testing.assert_array_equal(tile, ref)
    assert fits_native.read_tiles_batch(path, [[0, 200, 0, 200]]) is None
    assert fits_native.read_tiles_batch(path, [[5, 5, 0, 10]]) is None
    assert os.path.exists(os.path.join(fits_native._NATIVE_DIR,
                                       fits_native._LIB_NAME))
