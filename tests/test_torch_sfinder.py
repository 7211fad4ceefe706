"""The port's SFinder (tiled and serial) against the JAX package's on a
seeded FITS mosaic, and the golden mosaic fixture the card is held to.

The mosaic (208x208, NaN-blanked border and corner, a zero block) is
tiled into 96 px windows at step 0.75: a 3x3 grid whose last row and
column are truncated to 64 px, so four tile shapes, and one tile that
reads as all zeros.  A source sits on the corner shared by four tiles,
so the stitch merges it.  Preprocessing is the chan3 chain after
background subtraction, then min-max.  Both sides run in f32 with the
trained tests/fixtures/yolov8n_synth96.npz and are compared by the
catalog rule (equal count, same class, IoU >= 0.99, score within 1e-3)
with equal edge and merged flags.

tests/fixtures/torch_port_golden_mosaic_v8n96.npz holds the mosaic, the
run's configuration and the JAX SFinder.run_tiled sources;
tests/fixtures/torch_port_golden_mosaic_global_v8n96.npz the sources of
the same run on the device-resident path with the global preprocessing
context (device_tiling="on", preproc_context="global").  chip_smoke.py
runs the port on the card against both.  Regenerate them from the
repository root with
    PYTHONPATH=. python tests/test_torch_sfinder.py
"""

import contextlib
import json
import os

import numpy as np
import pytest

from caesar_yolo_tpu_torch.utils.boxes import catalog_mismatch
from caesar_yolo_tpu_torch.utils.fits import write_fits
from caesar_yolo_tpu_torch.utils.tiling import generate_tiles

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
GOLDEN = os.path.join(FIXTURES, "torch_port_golden_mosaic_v8n96.npz")
GOLDEN_GLOBAL = os.path.join(FIXTURES,
                             "torch_port_golden_mosaic_global_v8n96.npz")
GLOBAL = dict(device_tiling="on", preproc_context="global")
WEIGHTS = os.path.join(FIXTURES, "yolov8n_synth96.npz")
PREPROC = dict(subtract_bkg=True, chan3_preproc=True,
               sigma_clip_baseline=0.0, sigma_clip_low=1.0,
               sigma_clip_up=20.0, normalize_minmax=True)
CONFIG = dict(image_xmin=-1, image_xmax=-1, image_ymin=-1, image_ymax=-1,
              img_size=96, score_thr=0.3, split_image_in_tiles=True,
              tile_xsize=96, tile_ysize=96, tile_xstep=0.75,
              tile_ystep=0.75, batch_size=4)


def make_mosaic(n: int = 208) -> np.ndarray:
    """Seeded noise with Gaussian sources like the training set's; NaN
    along two edges and over the bottom-right corner tile, a zero block."""
    rng = np.random.default_rng(0)
    img = rng.normal(0.0, 0.08, (n, n)).astype(np.float32)
    yy, xx = np.mgrid[0:n, 0:n]
    for cx, cy in [(40, 44), (120, 40), (44, 124), (84, 84), (180, 110),
                   (118, 170)]:                  # (84, 84): 4-tile corner
        img += 6.0 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                            / (2 * 4.5 ** 2)).astype(np.float32)
    img[:3] = np.nan
    img[:, :3] = np.nan
    img[144:, 144:] = np.nan
    img[100:130, 0:20] = 0.0
    return img


def catalog_arrays(sources) -> tuple:
    """(boxes, scores, class_ids, edge, merged) of a catalog's objects
    (a serial run's objects have no merged flag: False)."""
    boxes = np.asarray([[s["x1"], s["y1"], s["x2"], s["y2"]]
                        for s in sources], np.float64).reshape(-1, 4)
    return (boxes, np.asarray([s["score"] for s in sources], np.float64),
            np.asarray([s["class_id"] for s in sources], np.int64),
            np.asarray([bool(s["edge"]) for s in sources]),
            np.asarray([bool(s.get("merged", False)) for s in sources]))


def jax_sfinder(path: str, tiled: bool, out_dir: str, extra=None) -> dict:
    """The reference's SFinder on the CPU in f32 (CONFIG updated by
    extra); returns the catalog."""
    import jax.numpy as jnp

    from caesar_yolo_tpu.models.convert import load_params
    from caesar_yolo_tpu.models.yolo import build_model
    from caesar_yolo_tpu.ops import build_preprocessor
    from caesar_yolo_tpu.parallel import SFinder, SFinderConfig

    params, meta = load_params(WEIGHTS)
    model = build_model(meta["model"], num_classes=int(meta["num_classes"]))
    kw = {**CONFIG, **(extra or {}), "split_image_in_tiles": tiled}
    cfg = SFinderConfig(image_path=path,
                        outfile_json=os.path.join(out_dir, "jax.json"),
                        outfile_ds9=os.path.join(out_dir, "jax.reg"), **kw)
    sf = SFinder(model, params, cfg,
                 preprocessor=build_preprocessor(**PREPROC),
                 engine_kwargs={"compute_dtype": jnp.float32})
    with contextlib.chdir(out_dir):      # its tile spool goes to the cwd
        assert (sf.run_tiled() if tiled else sf.run()) == 0
    return sf.sources


def port_sfinder(path: str, tiled: bool, out_dir: str, device="cpu",
                 extra=None):
    """The port's SFinder in f32 (CONFIG updated by extra), after its
    run."""
    import torch

    from caesar_yolo_tpu_torch.models.convert import load_model
    from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
    from caesar_yolo_tpu_torch.parallel.sfinder import SFinder, SFinderConfig

    model, _ = load_model(WEIGHTS)
    kw = {**CONFIG, **(extra or {}), "split_image_in_tiles": tiled}
    cfg = SFinderConfig(image_path=path,
                        outfile_json=os.path.join(out_dir, "port.json"),
                        outfile_ds9=os.path.join(out_dir, "port.reg"), **kw)
    sf = SFinder(model, cfg, preprocessor=build_preprocessor(**PREPROC),
                 engine_kwargs={"compute_dtype": torch.float32},
                 device=device)
    assert (sf.run_tiled() if tiled else sf.run()) == 0
    return sf


def load_golden(path: str = GOLDEN) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def golden_arrays(golden: dict) -> tuple:
    return tuple(golden[k] for k in ("boxes", "scores", "class_ids", "edge",
                                     "merged"))


def write_golden(tmp: str) -> tuple[dict, dict]:
    """The two fixtures' contents: the mosaic and the JAX catalog in tile
    context, and the JAX catalog in global context (its mosaic is the
    first fixture's)."""
    path = os.path.join(tmp, "mosaic.fits")
    mosaic = make_mosaic()
    write_fits(mosaic, path)
    out = []
    for extra in ({}, GLOBAL):
        srcs = catalog_arrays(jax_sfinder(path, True, tmp, extra)["sources"])
        out.append(dict(boxes=srcs[0], scores=srcs[1], class_ids=srcs[2],
                        edge=srcs[3], merged=srcs[4],
                        config=np.asarray(json.dumps({
                            "sfinder": dict(CONFIG, **extra),
                            "preprocessing": PREPROC}))))
    out[0]["mosaic"] = mosaic
    return out[0], out[1]


@pytest.fixture(scope="module")
def mosaic_runs(tmp_path_factory):
    """The mosaic as FITS, and the JAX SFinder's tiled and serial
    catalogs and DS9 texts on it (run once for the module)."""
    tmp = str(tmp_path_factory.mktemp("mosaic"))
    path = os.path.join(tmp, "mosaic.fits")
    write_fits(make_mosaic(), path)
    runs = {}
    for tiled in (True, False):
        out = os.path.join(tmp, "tiled" if tiled else "serial")
        os.makedirs(out)
        srcs = jax_sfinder(path, tiled, out)
        with open(os.path.join(out, "jax.reg")) as f:
            runs[tiled] = (srcs, f.read())
    out = os.path.join(tmp, "global")
    os.makedirs(out)
    runs["global"] = (jax_sfinder(path, True, out, GLOBAL), None)
    return path, runs


@pytest.mark.parametrize("tiled", [True, False], ids=["run_tiled", "run"])
def test_sfinder_matches_jax(mosaic_runs, tmp_path, tiled):
    path, runs = mosaic_runs
    ref, ref_reg = runs[tiled]
    sf = port_sfinder(path, tiled, str(tmp_path))
    if tiled:
        grid = generate_tiles(0, 207, 0, 207, 96, 96, 0.75, 0.75)
        assert len({(x1 - x0, y1 - y0) for x0, x1, y0, y1 in grid}) == 4
        assert sf.report.n_tiles == 9 and sf.report.tile_errors == []
        # the corner tile reads as zeros: no prediction on it
        assert len(sf.last_tile_results) == 8
        assert any(s["merged"] for s in ref["sources"]), "stitch expected"
    assert len(ref["sources"]) >= 5
    pair = catalog_arrays(ref["sources"]), catalog_arrays(
        sf.sources["sources"])
    assert catalog_mismatch(*pair) is None, catalog_mismatch(*pair)
    assert ([s["name"] for s in sf.sources["sources"]]
            == [s["name"] for s in ref["sources"]])
    reg = (tmp_path / "port.reg").read_text().splitlines()
    assert len(reg) == len(ref_reg.splitlines())
    for a, b in zip(reg, ref_reg.splitlines()):   # same region, colour, tags
        assert a.partition(")")[2] == b.partition(")")[2]


def test_golden_mosaic_fixture_is_current(mosaic_runs):
    """The committed JAX catalog equals a fresh JAX run on the mosaic."""
    golden = load_golden()
    np.testing.assert_array_equal(golden["mosaic"], make_mosaic())
    assert json.loads(str(golden["config"])) == {"sfinder": CONFIG,
                                                 "preprocessing": PREPROC}
    ref = catalog_arrays(mosaic_runs[1][True][0]["sources"])
    for k, r in zip(("class_ids", "edge", "merged"), ref[2:]):
        np.testing.assert_array_equal(golden[k], r, err_msg=k)
    # the same program on another CPU may round in other places
    np.testing.assert_allclose(golden["boxes"], ref[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(golden["scores"], ref[1], atol=1e-4, rtol=0)
    assert golden["merged"].any() and len(golden["scores"]) >= 5


def test_golden_mosaic_global_fixture_is_current(mosaic_runs):
    """The committed global-context JAX catalog equals a fresh JAX run
    (device_tiling="on", preproc_context="global") on the mosaic."""
    golden = load_golden(GOLDEN_GLOBAL)
    assert json.loads(str(golden["config"])) == {
        "sfinder": dict(CONFIG, **GLOBAL), "preprocessing": PREPROC}
    ref = catalog_arrays(mosaic_runs[1]["global"][0]["sources"])
    for k, r in zip(("class_ids", "edge", "merged"), ref[2:]):
        np.testing.assert_array_equal(golden[k], r, err_msg=k)
    np.testing.assert_allclose(golden["boxes"], ref[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(golden["scores"], ref[1], atol=1e-4, rtol=0)
    # the global statistics give another catalog than the tile context's
    tile = golden_arrays(load_golden())
    assert catalog_mismatch(tile, golden_arrays(golden)) is not None
    assert len(golden["scores"]) >= 5


def test_port_cpu_matches_golden_mosaic(tmp_path):
    """The port's run_tiled on the CPU against the fixture, by the
    catalog rule with flags (the card runs the same check in
    chip_smoke.py)."""
    golden = load_golden()
    path = str(tmp_path / "mosaic.fits")
    write_fits(golden["mosaic"], path)
    got = port_sfinder(path, True, str(tmp_path)).sources["sources"]
    ref = tuple(golden[k] for k in ("boxes", "scores", "class_ids", "edge",
                                    "merged"))
    assert catalog_mismatch(ref, catalog_arrays(got)) is None


def test_port_cpu_matches_golden_mosaic_global(tmp_path):
    """The port's run_tiled in the global context on the CPU against the
    global fixture, by the catalog rule with flags, on the full
    device-resident path (the card runs the same check in
    chip_smoke.py)."""
    golden = load_golden(GOLDEN_GLOBAL)
    path = str(tmp_path / "mosaic.fits")
    write_fits(load_golden()["mosaic"], path)
    extra = json.loads(str(golden["config"]))["sfinder"]
    sf = port_sfinder(path, True, str(tmp_path), extra=extra)
    got = catalog_arrays(sf.sources["sources"])
    assert catalog_mismatch(golden_arrays(golden), got) is None
    assert sf.report.tiling_mode == "full"
    assert "preprocess_mosaic" in sf.report.phase_times


if __name__ == "__main__":
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        outs = write_golden(tmp)
    for path, out in zip((GOLDEN, GOLDEN_GLOBAL), outs):
        np.savez_compressed(path, **out)
        print(f"wrote {path}: {len(out['scores'])} sources "
              f"({int(out['merged'].sum())} merged, "
              f"{int(out['edge'].sum())} edge), {os.path.getsize(path)} "
              f"bytes")
