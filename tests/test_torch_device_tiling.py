"""The port's device-resident tiling against the JAX package's: the three
tile paths (streamed windows, the whole mosaic on the device, full-width
bands), the global preprocessing context, the mode choice, the engine's
mosaic methods, --save_tile_img and --profile_dir.

Both sides run in f32 on the CPU on the seeded 208 px mosaic of
tests/test_torch_sfinder.py (3x3 tiles of 96 px at step 0.75, four tile
shapes, one all-zero tile) with the trained yolov8n_synth96 fixture.
Catalogs are compared by the catalog rule (equal count, same class, IoU
>= 0.99, score within 1e-3, equal edge and merged flags, equal names);
the whole-mosaic preprocessing within 2e-4 (ROADMAP.md, "Parity rules").
"""

import contextlib
import json
import logging
import os
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from caesar_yolo_tpu_torch import logger as port_logger
from caesar_yolo_tpu_torch.models.convert import load_model
from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
from caesar_yolo_tpu_torch.parallel.engine import TileEngine
from caesar_yolo_tpu_torch.parallel.sfinder import SFinder, SFinderConfig
from caesar_yolo_tpu_torch.utils.boxes import catalog_mismatch
from caesar_yolo_tpu_torch.utils.fits import read_fits, write_fits
from caesar_yolo_tpu_torch.utils.tiling import (
    generate_tiles,
    make_tile_windows,
)
from test_torch_sfinder import (
    CONFIG,
    PREPROC,
    WEIGHTS,
    catalog_arrays,
    make_mosaic,
    port_sfinder,
)

torch.set_num_threads(1)

N = 208                      # the mosaic's side
# one band's bytes in f32 (a grid row's 96 rows): the largest band fits
# under this cap, the whole mosaic does not, so "auto" takes the bands
BAND_CAP = N * 96 * 4
MODES = {"off": dict(device_tiling="off"), "on": dict(device_tiling="on"),
         "band": dict(device_tiling="auto",
                      device_tiling_max_bytes=BAND_CAP)}
PATHS = {"off": "stream", "on": "full", "band": "band"}
README = dict(zscale_stretch=True, normalize_minmax=True)


@pytest.fixture(scope="module")
def mosaic_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mosaic") / "mosaic.fits")
    write_fits(make_mosaic(), path)
    return path


@pytest.fixture(scope="module")
def jax_model():
    from caesar_yolo_tpu.models.convert import load_params
    from caesar_yolo_tpu.models.yolo import build_model
    params, meta = load_params(WEIGHTS)
    return build_model(meta["model"],
                       num_classes=int(meta["num_classes"])), params


@pytest.fixture(scope="module")
def jax_catalog(mosaic_path, jax_model, tmp_path_factory):
    """extra config -> the JAX SFinder.run_tiled catalog, every run
    through one compiled JAX TileEngine."""
    import jax.numpy as jnp

    from caesar_yolo_tpu.ops import build_preprocessor as jax_preprocessor
    from caesar_yolo_tpu.parallel import SFinder as JaxSFinder
    from caesar_yolo_tpu.parallel import SFinderConfig as JaxConfig

    model, params = jax_model
    out_dir = str(tmp_path_factory.mktemp("jax"))
    cache, state = {}, {"engine": None}

    def run(**extra):
        key = json.dumps(extra, sort_keys=True)
        if key not in cache:
            cfg = JaxConfig(image_path=mosaic_path,
                            outfile_json=os.path.join(out_dir, "jax.json"),
                            outfile_ds9=os.path.join(out_dir, "jax.reg"),
                            **{**CONFIG, **extra})
            sf = JaxSFinder(model, params, cfg,
                            preprocessor=jax_preprocessor(**PREPROC),
                            engine=state["engine"],
                            engine_kwargs={"compute_dtype": jnp.float32})
            with contextlib.chdir(out_dir):  # its spool goes to the cwd
                assert sf.run_tiled() == 0
            state["engine"] = sf._engine
            cache[key] = sf.sources["sources"]
        return cache[key]

    return run


@pytest.fixture(scope="module")
def model():
    return load_model(WEIGHTS)[0]


@pytest.fixture
def port_log(caplog):
    """caplog on the port's logger (which does not propagate)."""
    port_logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger=port_logger.name):
            yield caplog
    finally:
        port_logger.removeHandler(caplog.handler)


@pytest.mark.parametrize("mode,context", [
    ("off", "tile"), ("on", "tile"), ("band", "tile"), ("on", "global"),
    ("band", "global")])
def test_tiling_modes_match_jax(mosaic_path, jax_catalog, tmp_path,
                                port_log, mode, context):
    """Each device-tiling mode and statistics context gives the JAX
    SFinder's catalog in the same mode; global context off the full path
    falls back to the tile context with the reference's warning."""
    extra = dict(MODES[mode], preproc_context=context)
    ref = jax_catalog(**extra)
    sf = port_sfinder(mosaic_path, True, str(tmp_path), extra=extra)
    rep = sf.report
    assert rep.tiling_mode == PATHS[mode]
    assert rep.n_tiles == 9 and rep.n_local_tiles == 9
    if context == "tile" or mode != "on":   # the all-zero tile: no result
        assert len(sf.last_tile_results) == 8
    got = sf.sources["sources"]
    why = catalog_mismatch(catalog_arrays(ref), catalog_arrays(got))
    assert why is None, why
    assert [s["name"] for s in got] == [s["name"] for s in ref]
    fallback = context == "global" and mode != "on"
    assert ("falling back to per-tile statistics context"
            in port_log.text) == fallback
    assert ("preprocess_mosaic" in rep.phase_times) == (
        context == "global" and mode == "on")
    # the bytes each path ships: the whole mosaic once, each band once, or
    # every padded batch of windows
    assert rep.h2d_bytes == {"on": N * N * 4,
                             "band": N * (96 + 96 + 64) * 4,
                             "off": 4 * (96 + 64) ** 2 * 4}[mode]


def test_global_context_changes_the_catalog(jax_catalog):
    """The whole mosaic's statistics give another catalog than each
    tile's own (so the global runs above test something)."""
    tile = catalog_arrays(jax_catalog(**MODES["on"]))
    glob = catalog_arrays(jax_catalog(**MODES["on"],
                                      preproc_context="global"))
    assert catalog_mismatch(tile, glob) is not None


@pytest.mark.parametrize("step", [0.5, 0.75, 1.0])
def test_device_tiling_mode_matches_jax(mosaic_path, step):
    """_device_tiling_mode gives the JAX SFinder's answer over a grid of
    caps, modes, relay dtypes and resumed subsets (the tiles left after a
    spool's skips)."""
    from caesar_yolo_tpu.parallel import SFinder as JaxSFinder
    from caesar_yolo_tpu.parallel import SFinderConfig as JaxConfig
    from caesar_yolo_tpu.utils.tiling import (
        generate_tiles as jax_generate_tiles,
    )
    from caesar_yolo_tpu.utils.tiling import (
        make_tile_windows as jax_tile_windows,
    )

    import ml_dtypes

    kw = {**CONFIG, "tile_xstep": step, "tile_ystep": step}
    tiles = make_tile_windows(generate_tiles(0, N - 1, 0, N - 1, 96, 96,
                                             step, step))
    jtiles = jax_tile_windows(jax_generate_tiles(0, N - 1, 0, N - 1, 96, 96,
                                                 step, step))
    assert [(t.xmin, t.ymin, t.xmax, t.ymax) for t in tiles] == [
        (t.xmin, t.ymin, t.xmax, t.ymax) for t in jtiles]
    n = len(tiles)
    skips = [set(), {0}, set(range(n // 2)), set(range(1, n)),
             set(range(0, n, 2)), set(range(n))]
    full = N * N * 4
    caps = [2 ** 31, full, full - 1, N * 96 * 4, N * 96 * 4 - 1, 0]
    answers = set()
    for relay, np_dtype in ((torch.float32, np.float32),
                            (torch.bfloat16, ml_dtypes.bfloat16)):
        for device_tiling in ("auto", "on", "off"):
            for cap in caps:
                cfg = dict(kw, image_path=mosaic_path,
                           device_tiling=device_tiling,
                           device_tiling_max_bytes=cap)
                port = SFinder(None, SFinderConfig(**cfg), device="cpu")
                ref = JaxSFinder(None, None, JaxConfig(**cfg))
                assert port.set_img_size_params() == 0
                assert ref.set_img_size_params() == 0
                for skip in skips:
                    groups, jgroups = {}, {}
                    for t, jt in zip(tiles, jtiles):
                        if t.tid not in skip:
                            groups.setdefault((t.height, t.width),
                                              []).append(t)
                            jgroups.setdefault((jt.height, jt.width),
                                               []).append(jt)
                    got = port._device_tiling_mode(
                        SimpleNamespace(relay_dtype=relay), groups)
                    want = ref._device_tiling_mode(
                        SimpleNamespace(relay_np_dtype=np.dtype(np_dtype)),
                        jgroups)
                    assert got == want, (relay, device_tiling, cap, skip)
                    answers.add(got)
    assert answers == {"full", "band", None}


@pytest.fixture(scope="module")
def engines(model):
    """TileEngines in f32 on the CPU with the golden chain, with the same
    chain and a bf16 relay, and with no preprocessing."""
    kw = dict(img_size=96, score_thr=0.3, compute_dtype=torch.float32,
              device="cpu")
    return {"float32": TileEngine(model, preprocessor=build_preprocessor(
                **PREPROC), **kw),
            "bfloat16": TileEngine(model, preprocessor=build_preprocessor(
                **PREPROC), relay_dtype="bfloat16", **kw),
            "raw": TileEngine(model, **kw)}


ORIGINS = {(96, 96): [(0, 0), (72, 72), (112, 40), (0, 112), (0, 0)],
           (64, 96): [(144, 0), (144, 112), (0, 0)]}


@pytest.mark.parametrize("relay", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(ORIGINS), ids=["96x96", "64x96"])
def test_process_mosaic_async_equals_process(engines, relay, shape):
    """Windows cut on the device give process()'s outputs on the same
    windows cut on the host, bit for bit (the last slot is padding at
    (0, 0), as the SFinder pads its batches)."""
    engine = engines[relay]
    mosaic = make_mosaic()
    h, w = shape
    origins = np.asarray(ORIGINS[shape])
    windows = np.stack([mosaic[y:y + h, x:x + w] for y, x in origins])
    ref = engine.process(windows[..., None])
    got = engine.process_mosaic_async(engine.put_mosaic(mosaic), origins,
                                      shape)
    assert engine.put_mosaic(mosaic).dtype == getattr(torch, relay)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b.numpy())
    assert ref[4].sum() >= 2        # tiles the model predicts on


def test_process_mosaic_async_preprocessed(engines):
    """preprocessed=True: the windows of the preprocessed mosaic skip the
    pipeline, as process() of an engine without one on the same windows."""
    engine = engines["float32"]
    pre, ok = engine.preprocess_mosaic(engine.put_mosaic(make_mosaic()))
    assert ok and pre.shape == (N, N) and pre.is_contiguous()
    origins = np.asarray(ORIGINS[(96, 96)])
    windows = np.stack([pre.numpy()[y:y + 96, x:x + 96] for y, x in origins])
    ref = engines["raw"].process(windows[..., None])
    got = engine.process_mosaic_async(pre, origins, (96, 96),
                                      preprocessed=True)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b.numpy())


def test_process_mosaic_async_refuses_windows_off_the_mosaic(engines):
    engine = engines["float32"]
    mosaic = engine.put_mosaic(make_mosaic())
    for origins in ([(N - 95, 0)], [(0, -1)], [(0, N - 10)]):
        with pytest.raises(ValueError, match="leave the mosaic"):
            engine.process_mosaic_async(mosaic, np.asarray(origins),
                                        (96, 96))


@pytest.mark.parametrize("case", ["chan3", "readme", "zeros", "raw"])
def test_preprocess_mosaic_matches_jax(jax_model, case):
    """The whole-mosaic preprocessing (one gray plane, channel 0 kept)
    within 2e-4 of the JAX engine's, with an equal validity flag: the
    golden chain (bkg + chan3 + min-max), the README chain (on the mosaic
    with its NaN set to 0), an all-zero mosaic (invalid) and no pipeline
    (the mosaic unchanged)."""
    from caesar_yolo_tpu.ops import build_preprocessor as jax_preprocessor
    from caesar_yolo_tpu.parallel import TileEngine as JaxEngine

    chain = {"chan3": PREPROC, "readme": README, "zeros": PREPROC,
             "raw": None}[case]
    mosaic = make_mosaic()
    if case == "zeros":
        mosaic[:] = 0.0
    elif case == "readme":      # NaN among the zscale samples: invalid
        mosaic = np.nan_to_num(mosaic)
    jeng = JaxEngine(*jax_model, img_size=96, preprocessor=None
                     if chain is None else jax_preprocessor(**chain))
    want, want_ok = jeng.preprocess_mosaic(jeng.put_mosaic(mosaic))
    peng = TileEngine(load_model(WEIGHTS)[0], img_size=96, device="cpu",
                      preprocessor=None if chain is None
                      else build_preprocessor(**chain))
    got, got_ok = peng.preprocess_mosaic(peng.put_mosaic(mosaic))
    assert got_ok == want_ok == (case != "zeros")
    assert got.shape == (N, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("mode", list(MODES))
def test_save_tile_img_writes_the_windows(mosaic_path, tmp_path,
                                          monkeypatch, mode):
    """save_tile_img writes timg_<image>_tid<k>.fits for each predicted
    tile on every path, holding the tile's raw window as read (non-finite
    pixels 0)."""
    monkeypatch.chdir(tmp_path)
    sf = port_sfinder(mosaic_path, True, str(tmp_path),
                      extra=dict(MODES[mode], save_tile_img=True))
    mosaic = read_fits(mosaic_path)[0]
    assert np.isnan(make_mosaic()).any() and np.isfinite(mosaic).all()
    files = sorted(p.name for p in tmp_path.glob("timg_*.fits"))
    tids = sorted(tr["tileId"] for tr in sf.last_tile_results)
    assert files == sorted(f"timg_mosaic_tid{k}.fits" for k in tids)
    assert len(files) == 8          # the all-zero tile is not predicted on
    for tr in sf.last_tile_results:
        data = read_fits(str(tmp_path / f"timg_mosaic_tid{tr['tileId']}"
                                        f".fits"))[0]
        np.testing.assert_array_equal(
            data, mosaic[tr["ymin"]:tr["ymax"], tr["xmin"]:tr["xmax"]])


def test_profile_dir_leaves_a_trace(mosaic_path, tmp_path):
    """profile_dir: the tiled run is recorded by torch.profiler and written
    as a Chrome trace holding the run's operators."""
    prof = tmp_path / "prof"
    sf = port_sfinder(mosaic_path, True, str(tmp_path),
                      extra=dict(profile_dir=str(prof)))
    assert sf.report.n_tiles == 9
    trace = prof / "mosaic.trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)


def test_device_tiling_falls_back_when_the_mosaic_is_unreadable(
        mosaic_path, tmp_path, monkeypatch, port_log):
    """A failed whole-mosaic read sends every tile down the streaming path
    (the reference's fallback), with the same catalog."""
    from caesar_yolo_tpu_torch.parallel import sfinder as sf_mod
    os.makedirs(tmp_path / "a")
    ref = port_sfinder(mosaic_path, True, str(tmp_path / "a"),
                       extra=MODES["off"]).sources["sources"]
    real = sf_mod.read_fits_crop

    def no_mosaic(path, x0, x1, y0, y1, **kw):
        whole = (x1 - x0, y1 - y0) == (N, N)
        return None if whole else real(path, x0, x1, y0, y1, **kw)

    monkeypatch.setattr(sf_mod, "read_fits_crop", no_mosaic)
    sf = port_sfinder(mosaic_path, True, str(tmp_path), extra=MODES["on"])
    assert "full mosaic read failed" in port_log.text
    assert sf.report.tiling_mode == "stream"
    assert sf.sources["sources"] == ref


def test_band_read_failure_streams_that_bands_tiles(mosaic_path, tmp_path,
                                                    monkeypatch, port_log):
    """A band whose read fails sends its tiles to the streaming path; the
    catalog is the uninterrupted run's."""
    from caesar_yolo_tpu_torch.parallel import sfinder as sf_mod
    os.makedirs(tmp_path / "a")
    ref = port_sfinder(mosaic_path, True, str(tmp_path / "a"),
                       extra=MODES["band"]).sources["sources"]
    real = sf_mod.read_fits_crop

    def no_middle_band(path, x0, x1, y0, y1, **kw):
        band = (x1 - x0 == N) and y0 == 72
        return None if band else real(path, x0, x1, y0, y1, **kw)

    monkeypatch.setattr(sf_mod, "read_fits_crop", no_middle_band)
    sf = port_sfinder(mosaic_path, True, str(tmp_path), extra=MODES["band"])
    assert "Band read failed at rows [72,168)" in port_log.text
    assert sf.report.tiling_mode == "band+stream"
    assert sf.sources["sources"] == ref


def test_global_context_needs_no_preprocessor(mosaic_path, tmp_path, model):
    """Global context with no pipeline: the windows are the raw mosaic's,
    so the catalog is the tile context's."""
    cfg = SFinderConfig(image_path=mosaic_path,
                        outfile_json=str(tmp_path / "a.json"),
                        outfile_ds9=str(tmp_path / "a.reg"),
                        **{**CONFIG, **MODES["on"]})
    runs = []
    for context in ("tile", "global"):
        sf = SFinder(model, replace(cfg, preproc_context=context),
                     engine_kwargs={"compute_dtype": torch.float32},
                     device="cpu")
        assert sf.run_tiled() == 0
        runs.append(sf.sources["sources"])
    assert runs[0] == runs[1]
