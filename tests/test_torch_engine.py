"""The PyTorch port's slice end to end (TileEngine, Analyzer) against the
JAX package on the CPU, and the port's package rules (no JAX imported,
CUDA by default)."""

import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from caesar_yolo_tpu.detect.analyzer import Analyzer as JaxAnalyzer
from caesar_yolo_tpu.detect.analyzer import AnalyzerOutputs as JaxOutputs
from caesar_yolo_tpu.detect.predictor import Predictor as JaxPredictor
from caesar_yolo_tpu.models.convert import load_params
from caesar_yolo_tpu.models.yolo import build_model as jax_build_model
from caesar_yolo_tpu.ops import build_preprocessor as jax_build_preprocessor
from caesar_yolo_tpu.parallel.engine import TileEngine as JaxTileEngine
from caesar_yolo_tpu_torch.cli.run import main as cli_main
from caesar_yolo_tpu_torch.detect.analyzer import Analyzer, AnalyzerOutputs
from caesar_yolo_tpu_torch.detect.predictor import Predictor
from caesar_yolo_tpu_torch.models.convert import load_model
from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
from caesar_yolo_tpu_torch.parallel.engine import TileEngine
from caesar_yolo_tpu_torch.parallel.sfinder import SFinder, SFinderConfig
from caesar_yolo_tpu_torch.utils.boxes import catalog_mismatch, iou_matrix_np
from caesar_yolo_tpu_torch.utils.synth import make_mosaic, write_mosaic_fits

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "tests", "fixtures", "yolov8n_synth96.npz")
README = dict(zscale_stretch=True, normalize_minmax=True)
KW = dict(img_size=96, score_thr=0.3, iou_thr=0.5)


@pytest.fixture(scope="module")
def models():
    params, meta = load_params(WEIGHTS)
    jm = jax_build_model(meta["model"], num_classes=int(meta["num_classes"]))
    return jm, params, load_model(WEIGHTS)[0]


def _tiles(size, n=5, channels=1):
    tiles = np.stack([
        make_mosaic(size, size, n_sources=3, noise_sigma=0.08, seed=7 + i,
                    amp_range=(3.0, 8.0), sigma_range=(2.5, 5.0))[0]
        for i in range(n)])[..., None]
    tiles[2] = 1.5                                 # degenerate: constant
    return np.repeat(tiles, channels, axis=-1)


@pytest.mark.parametrize("size,channels,relay", [
    (96, 1, "float32"),      # gray tiles at the model size
    (80, 3, "float32"),      # 3-channel tiles, letterbox upscale
    (112, 1, "bfloat16"),    # downscale, bf16 host->device relay
])
def test_tile_engine_matches_jax(models, size, channels, relay):
    jm, params, tm = models
    tiles = _tiles(size, channels=channels)
    ref = JaxTileEngine(jm, params, compute_dtype=jnp.float32,
                        preprocessor=jax_build_preprocessor(**README),
                        relay_dtype=relay, **KW).process(tiles)
    got = TileEngine(tm, device="cpu", compute_dtype=torch.float32,
                     preprocessor=build_preprocessor(**README),
                     relay_dtype=relay, **KW).process(tiles)
    assert [g.shape for g in got] == [np.asarray(r).shape for r in ref]
    rb, rs, rc, rv, rok, rdrop = (np.asarray(r) for r in ref)
    gb, gs, gc, gv, gok, gdrop = got
    np.testing.assert_array_equal(gok, rok)
    assert not gok[2]
    np.testing.assert_array_equal(gdrop, rdrop)
    assert rv.sum() >= 5
    for i in range(len(tiles)):
        assert catalog_mismatch((rb[i][rv[i]], rs[i][rv[i]], rc[i][rv[i]]),
                                (gb[i][gv[i]], gs[i][gv[i]], gc[i][gv[i]])
                                ) is None, i


# bf16 catalog rule.  Two bf16 runs differ by rounding, not by a bug: on
# these tiles the JAX package's own bf16 scores lie up to 9.2e-3 from its
# f32 ones, detections near the threshold come and go, and a neighbouring
# anchor of the same source may win NMS (on tile 7 the port's box sits
# 4 px left of the reference's, IoU ~0.6).  So each detection clear of the
# threshold by BF16_MARGIN needs a partner on the other side of the same
# class and source (IoU >= 0.5, the usual detection-matching level) with
# a score within 0.025.
BF16_MARGIN, BF16_IOU, BF16_SCORE_TOL = 0.03, 0.5, 0.025


def _unpartnered(a, b, thr):
    """Detections of a (boxes, scores, classes) scoring >= thr that have
    no partner in b by the bf16 rule."""
    ab, as_, ac = a
    bb, bs, bc = b
    lonely = []
    for j in np.nonzero(as_ >= thr)[0]:
        iou = iou_matrix_np(ab[j:j + 1], bb.reshape(-1, 4))[0]
        if not ((iou >= BF16_IOU) & (bc == ac[j])
                & (np.abs(bs - as_[j]) <= BF16_SCORE_TOL)).any():
            lonely.append((ab[j], float(as_[j])))
    return lonely


def test_tile_engine_bf16_matches_jax_bf16(models):
    """The bf16 main path (the default compute dtype) against the JAX
    engine in bf16 on the same tiles, by the bf16 catalog rule."""
    jm, params, tm = models
    tiles = _tiles(96, n=8)
    ref = JaxTileEngine(jm, params, compute_dtype=jnp.bfloat16,
                        preprocessor=jax_build_preprocessor(**README),
                        **KW).process(tiles)
    got = TileEngine(tm, device="cpu", compute_dtype=torch.bfloat16,
                     preprocessor=build_preprocessor(**README),
                     **KW).process(tiles)
    rb, rs, rc, rv, rok, rdrop = (np.asarray(r) for r in ref)
    gb, gs, gc, gv, gok, gdrop = got
    np.testing.assert_array_equal(gok, rok)
    np.testing.assert_array_equal(gdrop, rdrop)
    assert rv.sum() >= 10
    thr = KW["score_thr"] + BF16_MARGIN
    for i in range(len(tiles)):
        r = (rb[i][rv[i]], rs[i][rv[i]], rc[i][rv[i]])
        g = (gb[i][gv[i]], gs[i][gv[i]], gc[i][gv[i]])
        assert not _unpartnered(r, g, thr), (i, _unpartnered(r, g, thr))
        assert not _unpartnered(g, r, thr), (i, _unpartnered(g, r, thr))


def test_analyzer_writes_the_reference_catalog(models, tmp_path):
    jm, params, tm = models
    image = _tiles(96)[0, :, :, 0]
    results = []
    for side, analyzer in (
            ("jax", JaxAnalyzer(
                JaxPredictor(jm, params, compute_dtype=jnp.float32, **KW),
                preprocessor=jax_build_preprocessor(**README),
                outputs=JaxOutputs(
                    outfile_json=str(tmp_path / "jax.json"),
                    outfile_ds9=str(tmp_path / "jax.reg")))),
            ("torch", Analyzer(
                Predictor(tm, device="cpu", compute_dtype=torch.float32,
                          **KW),
                preprocessor=build_preprocessor(**README),
                outputs=AnalyzerOutputs(
                    outfile_json=str(tmp_path / "torch.json"),
                    outfile_ds9=str(tmp_path / "torch.reg"))))):
        assert analyzer.predict(image, "img", xmin=100, ymin=50) == 0
        d = analyzer.detections
        results.append((d.boxes, d.scores, d.class_ids))
    assert len(results[0][1]) >= 2
    assert catalog_mismatch(*results) is None
    cats = [json.loads((tmp_path / f"{s}.json").read_text())
            for s in ("jax", "torch")]
    assert [o["name"] for o in cats[0]["objs"]] == [
        o["name"] for o in cats[1]["objs"]]
    for jo, to in zip(cats[0]["objs"], cats[1]["objs"]):
        assert to["class_name"] == jo["class_name"]
        for k in ("x1", "x2", "y1", "y2"):
            assert abs(to[k] - jo[k]) <= 1.0
    regs = [(tmp_path / f"{s}.reg").read_text().splitlines()
            for s in ("jax", "torch")]
    assert len(regs[1]) == len(regs[0]) == 2 + len(cats[0]["objs"])


def test_analyzer_skips_degenerate_image(models):
    _, _, tm = models
    analyzer = Analyzer(Predictor(tm, device="cpu",
                                  compute_dtype=torch.float32, **KW),
                        preprocessor=build_preprocessor(**README),
                        outputs=AnalyzerOutputs(write_json=False,
                                                write_ds9=False))
    assert analyzer.predict(np.zeros((96, 96), np.float32), "z") == -1
    assert analyzer.results == {"image_id": "z", "objs": []}


def test_entry_points_default_to_cuda(models, tmp_path):
    """Without a device argument an entry point runs on CUDA, and raises on
    a host without it instead of carrying on on the CPU."""
    _, _, tm = models
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        TileEngine(tm, **KW)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(tm, **KW)
    with pytest.raises(RuntimeError, match="CUDA"):
        SFinder(tm, SFinderConfig(image_path="m.fits"))
    image = str(tmp_path / "m.fits")
    write_mosaic_fits(image, nx=96, ny=96, n_sources=2)
    for tiles in ([], ["--split_img_in_tiles", "--tile_xsize=96",
                       "--tile_ysize=96"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_main([f"--image={image}", f"--weights={WEIGHTS}", *tiles])


def test_port_imports_no_jax():
    """Every module of the port imports with jax made unimportable, and
    loads neither jax nor the JAX package."""
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import caesar_yolo_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m == "jax" and sys.modules[m] is not None
       or m.startswith("jax.") or m.startswith("jaxlib")
       or m == "caesar_yolo_tpu" or m.startswith("caesar_yolo_tpu.")]
assert not bad, bad
need = {"parallel.sfinder", "parallel.stitch", "cli.run", "cli.preproc_args",
        "ops.stats", "ops.cuda_stats", "ops.histeq", "ops.cuda_histeq",
        "utils.fits", "utils.tiling", "ops.cuda_upsample", "ops.cuda_shift",
        "train.loss", "train.augment", "train.dataset", "train.trainer",
        "cli.train", "ops.clahe", "ops.cuda_clahe", "detect.batch",
        "evaluation.metrics", "evaluation.evaluate", "cli.evaluate",
        "models.convert", "cli.convert", "utils.synth5", "models.quant",
        "models.cuda_qconv"}
assert {pkg.__name__ + "." + n for n in need} <= set(names), names
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    assert not re.search(r"^\s*(from|import)\s+(jax|caesar_yolo_tpu)\b(?!_)",
                         src, re.MULTILINE)


def test_kernel_build_command(monkeypatch, tmp_path):
    """Each CUDA source builds for sm_90a into its own library whose name
    follows the source and flags; NMS, preprocessing, the clip statistics,
    histogram equalisation, CLAHE, the row shift, the int8 conv and the
    conv epilogue keep FMA contraction off (their outputs must equal the
    plain versions)."""
    from caesar_yolo_tpu_torch import cuda_build

    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: "/bin/true")
    for name, flags in cuda_build.SOURCES.items():
        cmd = cuda_build._command(name, str(tmp_path / "lib.so"))
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert cmd[-1].endswith(os.path.join("csrc", f"{name}.cu"))
        assert ("-fmad=false" in cmd) == (
            name in ("nms", "preproc", "stats", "histeq", "shift", "clahe",
                     "qconv", "epilogue"))
    assert {"stats", "histeq", "attn_bwd", "upsample", "shift",
            "clahe", "qconv", "epilogue"} <= set(cuda_build.SOURCES)
    path = cuda_build.library_path("nms")
    monkeypatch.setitem(cuda_build.SOURCES, "nms", [])
    assert cuda_build.library_path("nms") != path


def test_analyzer_unported_outputs_raise(models, tmp_path):
    """The Analyzer's FITS image and plot outputs, which the port once
    refused, write their files: the preprocessed image's first channel as
    FITS (equal to the JAX Analyzer's within 1e-6) and the plot as PNG."""
    pytest.importorskip("matplotlib")
    from caesar_yolo_tpu_torch.utils.fits import read_fits
    jm, params, tm = models
    pred = Predictor(tm, device="cpu", compute_dtype=torch.float32, **KW)
    image = _tiles(96)[0, :, :, 0]
    files = {k: str(tmp_path / f"a.{k}") for k in ("fits", "png", "jfits")}
    analyzer = Analyzer(pred, preprocessor=build_preprocessor(**README),
                        outputs=AnalyzerOutputs(
                            write_json=False, write_ds9=False, save_img=True,
                            draw=True, save_plot=True,
                            outfile_img=files["fits"],
                            outfile_plot=files["png"]))
    assert analyzer.predict(image, "t") == 0
    JaxAnalyzer(JaxPredictor(jm, params, compute_dtype=jnp.float32, **KW),
                preprocessor=jax_build_preprocessor(**README),
                outputs=JaxOutputs(write_json=False, write_ds9=False,
                                   save_img=True,
                                   outfile_img=files["jfits"])).predict(
        image, "t")
    got, ref = (read_fits(files[k])[0] for k in ("fits", "jfits"))
    assert got.shape == ref.shape == image.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)
    with open(files["png"], "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("path", ["tiles", "mosaic"])
def test_cpu_engine_captures_nothing_and_equals_the_step(models, path):
    """On the CPU every batch runs the step eagerly, however often its
    shape recurs: the run's counters hold eager batches alone, and each
    batch's outputs equal make_tile_step's on the same tiles bit for
    bit, through process_async and through process_mosaic_async."""
    from caesar_yolo_tpu_torch.parallel.engine import make_tile_step
    from caesar_yolo_tpu_torch.utils.trace import Recorder

    engine = TileEngine(models[2], device="cpu", compute_dtype=torch.float32,
                        preprocessor=build_preprocessor(**README), **KW)
    engine.recorder = Recorder()
    step = make_tile_step(engine.model,
                          preprocessor=build_preprocessor(**README), **KW)
    mosaic = make_mosaic(160, 160, n_sources=6, noise_sigma=0.08, seed=5,
                         amp_range=(3.0, 8.0), sigma_range=(2.5, 5.0))[0]
    shapes = [(96, 96)] * 3 + [(96, 64), (96, 96)]
    for k, (h, w) in enumerate(shapes):
        origins = np.array([[0, 0], [64 - k, 160 - w], [8 * k, 3]])
        tiles = np.stack([mosaic[r:r + h, c:c + w] for r, c in origins])
        if path == "tiles":
            got = engine.process_async(tiles[..., None])
        else:
            got = engine.process_mosaic_async(
                engine.put_mosaic(mosaic), origins, (h, w))
        ref = step(torch.from_numpy(tiles[..., None]))
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and torch.equal(g, r)
    assert engine.recorder.counters == {"engine.eager_batches": len(shapes)}
