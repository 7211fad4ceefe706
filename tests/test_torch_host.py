"""The port's host modules (FITS I/O, tiling, edge flags and stitch,
weights saving, the catalog palettes) against their JAX-package
counterparts: on the same inputs they must give the same outputs
exactly."""

import dataclasses

import numpy as np
import pytest
import torch

import caesar_yolo_tpu.outputs.catalog as jax_catalog
import caesar_yolo_tpu.parallel.stitch as jax_stitch
import caesar_yolo_tpu.utils.fits as jax_fits
import caesar_yolo_tpu.utils.tiling as jax_tiling
from caesar_yolo_tpu.models.convert import load_params as jax_load_params
from caesar_yolo_tpu.utils.synth import write_mosaic_fits as jax_write_mosaic
from caesar_yolo_tpu_torch.models.convert import (
    load_model,
    save_params,
    state_from_params,
)
from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
from caesar_yolo_tpu_torch.outputs import catalog
from caesar_yolo_tpu_torch.parallel import stitch
from caesar_yolo_tpu_torch.utils import fits, tiling
from caesar_yolo_tpu_torch.utils.synth import write_mosaic_fits


def _int16_fits(path, raw, extra=()):
    cards = [b"SIMPLE  =                    T", b"BITPIX  =                   16",
             b"NAXIS   =                    2",
             b"NAXIS1  = %20d" % raw.shape[1], b"NAXIS2  = %20d" % raw.shape[0],
             b"BSCALE  =                  2.0", b"BZERO   =                 10.0",
             *extra, b"END"]
    head = b"".join(c.ljust(80) for c in cards)
    head += b" " * (-len(head) % 2880)
    body = raw.astype(">i2").tobytes()
    body += b"\x00" * (-len(body) % 2880)
    with open(path, "wb") as f:
        f.write(head + body)


def _same_read(a, b):
    """Two read results: (data, header, wcs) equal, or both None."""
    if a is None or b is None:
        assert a is None and b is None
        return
    assert a[0].dtype == b[0].dtype and a[0].dtype.isnative
    np.testing.assert_array_equal(a[0], b[0])
    assert dict(a[1]) == dict(b[1])
    assert dataclasses.asdict(a[2]) == dataclasses.asdict(b[2])


@pytest.mark.parametrize("window", [(-1, -1, -1, -1), (0, 64, 0, 48),
                                    (5, 37, 11, 40), (0, 64, 7, 9),
                                    (60, 70, 0, 4), (9, 9, 0, 4)])
def test_fits_reads_match_jax(tmp_path, window):
    """Round trip through write_fits, full and windowed reads (including
    out-of-bounds and empty windows), NaN -> 0, big-endian -> native."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(48, 64)).astype(np.float32)
    data[3, 7] = np.nan
    header = fits.FitsHeader({"BMAJ": 0.001, "OBJECT": "testsrc",
                              "CDELT1": -1e-4, "CDELT2": 1e-4, "BMIN": 5e-4,
                              "BPA": 3.0, "PC1_2": 0.1})
    path = str(tmp_path / "rt.fits")
    fits.write_fits(data, path, header)
    ref = str(tmp_path / "ref.fits")
    jax_fits.write_fits(data, ref, jax_fits.FitsHeader(header))
    assert open(path, "rb").read() == open(ref, "rb").read()
    got = fits.read_fits_crop(path, *window, strip_deg_axis=True)
    _same_read(got, jax_fits.read_fits_crop(path, *window,
                                            strip_deg_axis=True))
    if window == (-1, -1, -1, -1):
        assert got[0][3, 7] == 0
        mask = np.isfinite(data)
        np.testing.assert_array_equal(got[0][mask], data[mask])
        assert torch.from_numpy(got[0]).shape == (48, 64)
        assert fits.get_fits_size(path) == jax_fits.get_fits_size(path)
        assert (fits.beam_area_from_header(got[1])
                == jax_fits.beam_area_from_header(got[1]))


def test_truncated_fits_match_jax(tmp_path):
    """A file cut inside its data section reads where the window's bytes
    are all present and fails (None) where they are not, as the JAX
    reader's row-by-row reads do."""
    data = np.random.default_rng(2).normal(size=(30, 20)).astype(np.float32)
    path = str(tmp_path / "full.fits")
    fits.write_fits(data, path)
    raw = open(path, "rb").read()
    last = 2880 + (9 * 20 + 15) * 4              # end of window (5:15, 0:10)
    for cut in (2880, 2880 + 500, last - 1, last, len(raw) - 2000):
        cpath = str(tmp_path / f"cut{cut}.fits")
        open(cpath, "wb").write(raw[:cut])
        for window in ((5, 15, 0, 10), (0, 20, 25, 30), (-1, -1, -1, -1)):
            _same_read(fits.read_fits_crop(cpath, *window),
                       jax_fits.read_fits_crop(cpath, *window))
    assert fits.read_fits_crop(str(tmp_path / f"cut{last}.fits"),
                               5, 15, 0, 10) is not None


def test_fits_int16_bscale_blank_and_degenerate_axes(tmp_path):
    raw = np.arange(-8, 8).reshape(4, 4)
    path = str(tmp_path / "i16.fits")
    _int16_fits(path, raw, [b"BLANK   =                   -3"])
    for window in ((-1, -1, -1, -1), (1, 3, 0, 4)):
        got = fits.read_fits_crop(path, *window)
        _same_read(got, jax_fits.read_fits_crop(path, *window))
    out = fits.read_fits(path)[0]
    assert out.dtype == np.float32 and out.dtype.isnative
    assert out[1, 1] == 0.0                       # BLANK -> NaN -> 0
    assert out[0, 0] == -8 * 2.0 + 10.0
    # a 4-D cube with degenerate axes squeezes to 2-D, keys stripped
    rng = np.random.default_rng(1)
    cube = rng.normal(size=(1, 1, 16, 20)).astype(np.float32)
    cpath = str(tmp_path / "cube.fits")
    fits.write_fits(cube, cpath, fits.FitsHeader({"CTYPE3": "FREQ",
                                                  "PC3_1": 0.0}))
    for window in ((-1, -1, -1, -1), (2, 10, 4, 12)):
        got = fits.read_fits_crop(cpath, *window, strip_deg_axis=True)
        _same_read(got, jax_fits.read_fits_crop(cpath, *window,
                                                strip_deg_axis=True))
        assert got[1]["NAXIS"] == 2 and "CTYPE3" not in got[1]
    assert fits.read_fits(cpath)[0].shape == (16, 20)
    h = fits.get_fits_header(cpath)
    assert dict(h) == dict(jax_fits.get_fits_header(cpath))
    assert fits.read_fits(str(tmp_path / "missing.fits")) is None


def test_write_mosaic_fits_matches_jax(tmp_path):
    a, b = str(tmp_path / "a.fits"), str(tmp_path / "b.fits")
    kw = dict(nx=120, ny=90, n_sources=5, seed=3)
    np.testing.assert_array_equal(write_mosaic_fits(a, **kw),
                                  jax_write_mosaic(b, **kw))
    assert open(a, "rb").read() == open(b, "rb").read()
    write_mosaic_fits(a, blank_border=4, **kw)
    raw = fits.read_fits(a)
    assert (raw[0][:4] == 0).all() and (raw[0][:, -4:] == 0).all()
    np.testing.assert_array_equal(raw[0][4:-4, 4:-4],
                                  jax_fits.read_fits(b)[0][4:-4, 4:-4])


@pytest.mark.parametrize("args", [
    (0, 2559, 0, 2559, 512, 512, 0.5, 0.5),      # 10 x 10, last 256 px
    (0, 207, 0, 207, 96, 96, 0.75, 0.75),
    (10, 300, 5, 200, 64, 48, 1.0, 0.3),
    (0, 99, 0, 99, 128, 32, 0.5, 0.5),            # tile wider than image
    (0, 99, 0, 99, 32, 32, 0.0, 0.5),             # invalid step
])
def test_tiling_matches_jax(args):
    grid = tiling.generate_tiles(*args)
    assert grid == jax_tiling.generate_tiles(*args)
    if grid is None:
        return
    tiles = tiling.make_tile_windows(grid)
    ref = jax_tiling.make_tile_windows(grid)
    assert [dataclasses.astuple(t) for t in tiles] == [
        dataclasses.astuple(t) for t in ref]
    assert tiling.neighbor_table(tiles) == jax_tiling.neighbor_table(ref)
    if args[4] == 512:
        assert len(grid) == 100
        assert {(x1 - x0, y1 - y0) for x0, x1, y0, y1 in grid} == {
            (512, 512), (256, 512), (512, 256), (256, 256)}


def _tile_results(rng, tiles):
    """Seeded per-tile objects in mosaic coordinates, some on tile bounds
    and in overlaps, with equal-area duplicates across tiles."""
    nb = tiling.neighbor_table(tiles)
    out = []
    for t in tiles:
        objs = []
        for k in range(int(rng.integers(1, 6))):
            x1 = float(rng.integers(t.xmin, t.xmax - 4))
            y1 = float(rng.integers(t.ymin, t.ymax - 4))
            w, h = rng.integers(2, 30, size=2)
            if k == 0:
                x1 = float(t.xmin)                 # on the tile bound
            objs.append({"name": f"S{k + 1}_t{t.tid}", "x1": x1,
                         "x2": float(min(x1 + w, t.xmax)), "y1": y1,
                         "y2": float(min(y1 + h, t.ymax)),
                         "class_id": int(rng.integers(0, 5)),
                         "class_name": "compact",
                         "score": float(rng.choice([0.5, 0.75, 0.9])),
                         "edge": 0})
        out.append({"objs": objs, "tileId": t.tid,
                    "neighborTileIds": nb[t.tid]})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edge_flags_and_stitch_match_jax(seed):
    grid = tiling.generate_tiles(0, 199, 0, 159, 64, 64, 0.5, 0.75)
    tiles = tiling.make_tile_windows(grid)
    got = _tile_results(np.random.default_rng(seed), tiles)
    ref = _tile_results(np.random.default_rng(seed), tiles)
    jtiles = {t.tid: jax_tiling.TileWindow(*dataclasses.astuple(t))
              for t in tiles}
    for g, r in zip(got, ref):
        stitch.flag_edge_sources(
            g["objs"], tiles[g["tileId"]],
            [tiles[i] for i in g["neighborTileIds"]])
        jax_stitch.flag_edge_sources(
            r["objs"], jtiles[r["tileId"]],
            [jtiles[i] for i in r["neighborTileIds"]])
    assert got == ref
    assert any(o["edge"] for g in got for o in g["objs"])
    out = stitch.stitch_tile_sources(got)
    assert out == jax_stitch.stitch_tile_sources(ref)
    names = [s["name"] for s in out["sources"]]
    assert names == [f"S{i + 1}" for i in range(len(names))]
    assert any(s["merged"] for s in out["sources"])


def test_half_open_edge_comparisons():
    """A source starting exactly at a neighbour's xmax lies outside it;
    one ending exactly at its xmin overlaps it (closed min side)."""
    t = tiling.TileWindow(0, 64, 0, 64, 0)
    nb = tiling.TileWindow(32, 96, 0, 64, 1)
    outside = {"x1": 96.0, "x2": 100.0, "y1": 10.0, "y2": 20.0}
    touching = {"x1": 10.0, "x2": 32.0, "y1": 10.0, "y2": 20.0}
    for objs in ([dict(outside)], [dict(touching)]):
        ref = [dict(o) for o in objs]
        stitch.flag_edge_sources(objs, t, [nb])
        jax_stitch.flag_edge_sources(ref, jax_tiling.TileWindow(0, 64, 0, 64),
                                     [jax_tiling.TileWindow(32, 96, 0, 64)])
        assert objs == ref
    assert touching.get("edge") is None


def test_save_params_round_trip(tmp_path):
    """save_params writes the reference's npz: the JAX load_params reads
    it, and weights survive both formats exactly."""
    model = init_weights(build_model("yolov8n"), seed=3)
    path = save_params(model, str(tmp_path / "w"), meta={"model": "yolov8n",
                                                         "num_classes": 5})
    assert path.endswith(".npz")
    jparams, jmeta = jax_load_params(path)
    assert jmeta == {"model": "yolov8n", "num_classes": 5}
    state = state_from_params(jparams)
    ref = model.state_dict()
    assert state.keys() == ref.keys()
    for k in ref:
        assert torch.equal(state[k], ref[k].float()), k
    again, _ = load_model(path)
    for k, v in again.state_dict().items():
        assert torch.equal(v, ref[k]), k


def test_mosaic_palette_matches_jax():
    assert catalog.CLASS_COLOR_MAP_DS9_MOSAIC == \
        jax_catalog.CLASS_COLOR_MAP_DS9_MOSAIC
    assert catalog.CLASS_COLOR_MAP_DS9 == jax_catalog.CLASS_COLOR_MAP_DS9
