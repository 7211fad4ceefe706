"""The port's crash-resume spool against the JAX package's.

Port twins of tests/test_aux.py's spool tests (which need the reference
galaxy FITS) on the seeded 208 px mosaic of tests/test_torch_sfinder.py,
with the trained yolov8n_synth96 fixture in f32 on the CPU; and spools
crossing between the packages: a spool the JAX SFinder wrote, cut after
k records with a torn record behind them as a crash leaves it, resumes
in the port to the uninterrupted catalog, and the other way round.
Catalogs of the two packages are compared by the catalog rule (equal
count, same class, IoU >= 0.99, score within 1e-3, equal edge and merged
flags) and equal names.
"""

import contextlib
import json
import os
import shutil

import pytest
import torch

from caesar_yolo_tpu_torch.cli.run import _per_image_path
from caesar_yolo_tpu_torch.models.convert import load_model
from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
from caesar_yolo_tpu_torch.parallel.sfinder import SFinder, SFinderConfig
from caesar_yolo_tpu_torch.utils.boxes import catalog_mismatch
from caesar_yolo_tpu_torch.utils.fits import write_fits
from test_torch_sfinder import (
    CONFIG,
    PREPROC,
    WEIGHTS,
    catalog_arrays,
    make_mosaic,
)

torch.set_num_threads(1)

SPOOL = ".mosaic.tilespool.jsonl"       # the default spool of mosaic.fits


def fake_record(score, tid=0, size=96):
    """A spooled tile result holding one object of the given score."""
    obj = {"name": f"S1_t{tid}", "x1": 1.0, "x2": 5.0, "y1": 1.0,
           "y2": 5.0, "class_id": 1, "class_name": "compact",
           "score": score, "edge": 0}
    return json.dumps({"objs": [obj], "tileId": tid, "workerId": 0,
                       "neighborTileIds": [], "xmin": 0, "xmax": size,
                       "ymin": 0, "ymax": size}) + "\n"


@pytest.fixture(scope="module")
def model():
    return load_model(WEIGHTS)[0]


@pytest.fixture
def mosaic(tmp_path, monkeypatch):
    """mosaic.fits in a fresh working directory (where the default spool
    and catalog go)."""
    monkeypatch.chdir(tmp_path)
    write_fits(make_mosaic(), str(tmp_path / "mosaic.fits"))
    return str(tmp_path / "mosaic.fits")


def port(model, path, **kw):
    cfg = SFinderConfig(image_path=path, **{**CONFIG, **kw})
    return SFinder(model, cfg, preprocessor=build_preprocessor(**PREPROC),
                   engine_kwargs={"compute_dtype": torch.float32},
                   device="cpu")


def catalog(name="catalog_mosaic.json"):
    with open(name) as f:
        return json.load(f)["sources"]


def test_spool_resume_skips_done_tiles(model, mosaic, tmp_path):
    """A tile result already in the spool is not recomputed and appears in
    the final catalog; the spool is removed after the run."""
    sf = port(model, mosaic, resume=True)
    spool = tmp_path / SPOOL
    spool.write_text(json.dumps({"gridSig": sf._grid_signature()}) + "\n"
                     + fake_record(0.99))
    assert sf.run_tiled() == 0
    assert 0.99 in {s["score"] for s in catalog()}
    assert sf.report.n_resumed == 1
    assert sf.report.n_local_tiles == sf.report.n_tiles - 1
    assert not spool.exists()


@pytest.mark.parametrize("mode", ["on", "band"])
def test_spool_resume_with_device_tiling(model, mosaic, tmp_path, mode):
    """Resume composes with device-resident tiling, full and banded: the
    spooled tile is not recomputed and survives into the catalog."""
    kw = (dict(device_tiling="on") if mode == "on" else
          dict(device_tiling="auto", device_tiling_max_bytes=208 * 96 * 4))
    sf = port(model, mosaic, resume=True, **kw)
    spool = tmp_path / SPOOL
    spool.write_text(json.dumps({"gridSig": sf._grid_signature()}) + "\n"
                     + fake_record(0.98))
    assert sf.run_tiled() == 0
    assert 0.98 in {s["score"] for s in catalog()}
    assert sf.report.n_local_tiles == sf.report.n_tiles - 1
    assert sf.report.tiling_mode == {"on": "full", "band": "band"}[mode]
    assert not spool.exists()


def test_spool_rejected_on_config_change(model, mosaic, tmp_path):
    """A spool written under another tiling is ignored (its tile ids
    name other windows), and so is a legacy spool without a signature."""
    old = port(model, mosaic, resume=True, tile_xsize=64, tile_ysize=64)
    record = fake_record(0.97, tid=8, size=64)
    spool = tmp_path / SPOOL
    for content in (json.dumps({"gridSig": old._grid_signature()}) + "\n"
                    + record, record):
        spool.write_text(content)
        sf = port(model, mosaic, resume=True)
        assert sf.run_tiled() == 0
        assert 0.97 not in {s["score"] for s in catalog()}
        assert sf.report.n_resumed == 0


def test_spool_guard_max_tasks(model, mosaic):
    """More tiles than max_ntasks_per_worker: the run is refused."""
    sf = port(model, mosaic, tile_xsize=33, tile_ysize=33,
              tile_xstep=1.0, tile_ystep=1.0, max_ntasks_per_worker=3)
    assert sf.run_tiled() == -1


def test_spool_rejected_on_different_image(model, mosaic, tmp_path):
    """A spool written for another image (a --spool_path shared across a
    datalist) is ignored: the signature carries the image path."""
    other = tmp_path / "other_field.fits"
    shutil.copy(mosaic, other)
    spool = tmp_path / "shared.spool.jsonl"
    sf_other = port(model, str(other), resume=True, spool_path=str(spool))
    spool.write_text(json.dumps({"gridSig": sf_other._grid_signature()})
                     + "\n" + fake_record(0.95))
    sf = port(model, mosaic, resume=True, spool_path=str(spool))
    assert sf.run_tiled() == 0
    assert 0.95 not in {s["score"] for s in catalog()}


def test_datalist_per_image_spool_path():
    """Datalist runs suffix a fixed --spool_path per image."""
    assert _per_image_path("s.jsonl", "a/field.fits", 3) == "s_field.jsonl"
    assert _per_image_path("s.jsonl", "x.fits", 1) == "s.jsonl"
    assert _per_image_path("", "x.fits", 3) == ""


def test_spool_torn_tail_keeps_complete_results(model, mosaic, tmp_path):
    """A crash mid-write leaves a torn last record: resume keeps every
    complete record and drops only the torn one."""
    sf = port(model, mosaic, resume=True)
    spool = tmp_path / SPOOL
    spool.write_text(json.dumps({"gridSig": sf._grid_signature()}) + "\n"
                     + fake_record(0.99)
                     + '{"objs": [{"name": "S1_t1", "x1": 2.0, ')
    assert set(sf._load_spool(sf._grid_signature())) == {0}
    assert sf.run_tiled() == 0
    assert 0.99 in {s["score"] for s in catalog()}


@contextlib.contextmanager
def keep_spool(monkeypatch, spool):
    """The spool stays on disk when a run ends (a finished run removes
    it), so that a test can cut it as a crash would have left it."""
    real = os.remove

    def remove(path, *args, **kwargs):
        if os.path.abspath(path) != os.path.abspath(spool):
            real(path, *args, **kwargs)

    with monkeypatch.context() as m:
        m.setattr(os, "remove", remove)
        yield


def test_records_after_a_torn_line_survive_another_resume(
        model, mosaic, tmp_path, monkeypatch):
    """A resumed run appends after a torn record on a line of its own, so
    a second crash and resume keep every record the first resume wrote."""
    spool = tmp_path / SPOOL
    sf = port(model, mosaic, resume=True)
    sig = sf._grid_signature()
    spool.write_text(json.dumps({"gridSig": sig}) + "\n" + fake_record(0.99)
                     + '{"objs": [{"name": "S1_t1", "x1": 2.0, ')
    with keep_spool(monkeypatch, spool):
        assert sf.run_tiled() == 0
    again = port(model, mosaic, resume=True)
    done = again._load_spool(sig)
    assert sorted(done) == sorted(tr["tileId"]
                                  for tr in sf.last_tile_results)
    assert len(done) == 8 and done[0]["objs"][0]["score"] == 0.99


def test_grid_signature_matches_jax(model, mosaic):
    """The port's grid signature is the JAX SFinder's (one process: stripe
    [0, 1]), for the default and a cropped, resized configuration."""
    from caesar_yolo_tpu.parallel import SFinder as JaxSFinder
    from caesar_yolo_tpu.parallel import SFinderConfig as JaxConfig

    for kw in ({}, dict(image_xmin=4, image_xmax=200, image_ymin=0,
                        image_ymax=150, tile_xsize=64, tile_ystep=0.5,
                        score_thr=0.25, iou_thr=0.45, pre_nms=1024,
                        img_size=128)):
        cfg = {**CONFIG, **kw, "image_path": mosaic}
        got = port(model, mosaic, **{**CONFIG, **kw})._grid_signature()
        want = JaxSFinder(None, None, JaxConfig(**cfg))._grid_signature()
        assert got == want
        assert json.loads(json.dumps(got)) == got


@pytest.fixture(scope="module")
def jax_engine():
    """One compiled JAX TileEngine for the cross-package runs."""
    return {}


def jax_run(path, engine_cache, **kw):
    import jax.numpy as jnp

    from caesar_yolo_tpu.models.convert import load_params
    from caesar_yolo_tpu.models.yolo import build_model
    from caesar_yolo_tpu.ops import build_preprocessor as jax_preprocessor
    from caesar_yolo_tpu.parallel import SFinder as JaxSFinder
    from caesar_yolo_tpu.parallel import SFinderConfig as JaxConfig

    params, meta = load_params(WEIGHTS)
    jmodel = build_model(meta["model"], num_classes=int(meta["num_classes"]))
    sf = JaxSFinder(jmodel, params,
                    JaxConfig(image_path=path, **{**CONFIG, **kw}),
                    preprocessor=jax_preprocessor(**PREPROC),
                    engine=engine_cache.get("engine"),
                    engine_kwargs={"compute_dtype": jnp.float32})
    assert sf.run_tiled() == 0
    engine_cache["engine"] = sf._engine
    return sf


def cut_spool(spool, k):
    """The spool as a crash after k records leaves it: the signature, k
    complete records and half of the next one, with no newline."""
    lines = spool.read_text().splitlines(keepends=True)
    assert len(lines) >= k + 2
    spool.write_text("".join(lines[:1 + k])
                     + lines[1 + k][:len(lines[1 + k]) // 2])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_spool_resumes_across_packages(model, mosaic, tmp_path, monkeypatch,
                                       jax_engine, writer):
    """A spool written by one package and cut after 3 records and a torn
    one resumes in the other to the uninterrupted run's catalog: the
    signatures and records are the same format."""
    spool = tmp_path / "run.spool.jsonl"
    k = 3

    def run(package, **kw):
        if package == "jax":
            return jax_run(mosaic, jax_engine, spool_path=str(spool), **kw)
        sf = port(model, mosaic, spool_path=str(spool), **kw)
        assert sf.run_tiled() == 0
        return sf

    with keep_spool(monkeypatch, spool):
        first = run(writer)
    whole = catalog()
    assert len(spool.read_text().splitlines()) == 1 + 8
    cut_spool(spool, k)
    kept = [json.loads(line)["tileId"]
            for line in spool.read_text().splitlines()[1:1 + k]]
    reader = "port" if writer == "jax" else "jax"
    resumed = run(reader, resume=True)
    assert not spool.exists()
    got = catalog()
    why = catalog_mismatch(catalog_arrays(whole), catalog_arrays(got))
    assert why is None, why
    assert [s["name"] for s in got] == [s["name"] for s in whole]
    assert len(resumed.last_tile_results) == len(first.last_tile_results)
    if reader == "port":
        assert resumed.report.n_resumed == k
        assert resumed.report.n_local_tiles == 9 - k
    # the resumed tiles' objects are the writer's, bit for bit
    spooled = {tr["tileId"]: tr for tr in first.last_tile_results}
    again = {tr["tileId"]: tr for tr in resumed.last_tile_results}
    assert sorted(again) == sorted(spooled)
    for tid in kept:
        assert ([o["score"] for o in again[tid]["objs"]]
                == [o["score"] for o in spooled[tid]["objs"]])
