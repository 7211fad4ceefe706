"""The port's evaluation slice against the JAX package on the CPU: the
metrics and mAP on fixed prediction/label sets, the BatchedDetector on
mixed shapes with an unreadable image and partial batches, cli.evaluate
and the three routes of cli.run --datalist against the JAX CLIs on a
small FITS set (yolov8n_synth96 in f32), TileEngine.update_params, and
validation during cli.train (the `best` checkpoint and its metric across
--resume)."""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caesar_yolo_tpu.detect.predictor as jax_predictor
import caesar_yolo_tpu.parallel.engine as jax_engine
from caesar_yolo_tpu.cli import evaluate as jax_cli_evaluate
from caesar_yolo_tpu.cli import run as jax_cli_run
from caesar_yolo_tpu.detect.batch import BatchedDetector as JaxDetector
from caesar_yolo_tpu.evaluation import metrics as jm
from caesar_yolo_tpu.models.convert import load_params
from caesar_yolo_tpu.models.yolo import build_model as jax_build_model
from caesar_yolo_tpu_torch import evaluation
from caesar_yolo_tpu_torch.cli import evaluate as cli_evaluate
from caesar_yolo_tpu_torch.cli import run as cli_run
from caesar_yolo_tpu_torch.detect import predictor as port_predictor
from caesar_yolo_tpu_torch.detect.batch import BatchedDetector
from caesar_yolo_tpu_torch.evaluation import metrics as tm
from caesar_yolo_tpu_torch.models.convert import load_model
from caesar_yolo_tpu_torch.outputs.catalog import CLASS_NAMES
from caesar_yolo_tpu_torch.parallel import engine as port_engine
from caesar_yolo_tpu_torch.utils.boxes import catalog_mismatch
from caesar_yolo_tpu_torch.utils.synth import (
    make_mosaic,
    write_labelled_cutouts,
)
from caesar_yolo_tpu_torch.utils.trace import Recorder

torch.set_num_threads(1)

WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "yolov8n_synth96.npz")
# cutouts like yolov8n_synth96's training set (round sources, class 1)
CUTOUTS = dict(label=1, noise_sigma=0.08, amp_range=(3.0, 8.0),
               sigma_range=(3.0, 6.0))


# -- metrics and mAP ---------------------------------------------------------

def _sets(seed, n_img=8):
    """Per-image gt/pred dicts: jittered copies of gt boxes (some with
    another label, some exact duplicates), random false positives, images
    without gt or without predictions."""
    rng = np.random.default_rng(seed)
    gts, preds = [], []
    for _ in range(n_img):
        ng, nfp = int(rng.integers(0, 5)), int(rng.integers(0, 3))
        xy = rng.uniform(0, 80, (ng, 2))
        gb = np.concatenate([xy, xy + rng.uniform(4, 20, (ng, 2))], 1)
        gl = [CLASS_NAMES[k] for k in rng.integers(0, 5, ng)]
        keep = rng.random(ng) < 0.8
        pb = gb[keep] + rng.normal(0, 1.5, (int(keep.sum()), 4))
        pl = [lab if rng.random() < 0.7 else CLASS_NAMES[rng.integers(0, 5)]
              for lab in np.asarray(gl, object)[keep]]
        fxy = rng.uniform(0, 80, (nfp, 2))
        pb = np.concatenate([pb, np.concatenate(
            [fxy, fxy + rng.uniform(4, 20, (nfp, 2))], 1)])
        pl += [CLASS_NAMES[k] for k in rng.integers(0, 5, nfp)]
        if len(pb) and rng.random() < 0.3:
            pb, pl = np.concatenate([pb, pb[:1]]), pl + pl[:1]
        scores = np.round(rng.random(len(pb)), 2)   # ties included
        gts.append({"bboxes": gb.reshape(-1, 4), "labels": gl})
        preds.append({"bboxes": pb.reshape(-1, 4), "labels": pl,
                      "scores": scores})
    return gts, preds


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("iou_thr", [0.6, 0.4])
def test_metrics_match_jax(seed, iou_thr):
    gts, preds = _sets(seed)
    ref = jm.compute_metrics(gts, preds, iou_thr)
    got = tm.compute_metrics(gts, preds, iou_thr)
    for a, b in ((ref.completeness, got.completeness),
                 (ref.reliability, got.reliability)):
        assert {k: (v.n, v.n_matched) for k, v in a.items()} == {
            k: (v.n, v.n_matched) for k, v in b.items()}
    np.testing.assert_array_equal(list(got.f1.values()),
                                  list(ref.f1.values()))
    assert got.summary() == ref.summary()
    rmap, gmap = jm.compute_map(gts, preds), tm.compute_map(gts, preds)
    assert gmap.summary() == rmap.summary()
    for k in ("per_class_ap50", "per_class_ap"):
        assert getattr(gmap, k) == getattr(rmap, k)
    assert (gmap.map50, gmap.map75, gmap.map50_95) == (
        rmap.map50, rmap.map75, rmap.map50_95)
    assert gmap.best_thresholds() == rmap.best_thresholds()
    for label, curves in rmap.pr_curves.items():
        for r, g in zip(curves, gmap.pr_curves[label]):
            np.testing.assert_array_equal(g, r)
    keys = [f"im{i}" for i in range(len(gts))]
    assert tm.per_image_match_detail(keys, gts, preds, iou_thr) == \
        jm.per_image_match_detail(keys, gts, preds, iou_thr)


def test_read_yolo_labels_matches_jax(tmp_path):
    p = tmp_path / "a.txt"
    p.write_text("1 0.5 0.5 0.2 0.4\n2 0.25 0.25 0.1 0.1\nbad\n4 0 0 1 1\n")
    for path in (str(p), str(tmp_path / "missing.txt")):
        ref = jm.read_yolo_labels(path, 100, 80, CLASS_NAMES)
        got = tm.read_yolo_labels(path, 100, 80, CLASS_NAMES)
        np.testing.assert_array_equal(got["bboxes"], ref["bboxes"])
        assert got["labels"] == ref["labels"]


# -- BatchedDetector -----------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    params, meta = load_params(WEIGHTS)
    jmodel = jax_build_model(meta["model"],
                             num_classes=int(meta["num_classes"]))
    return jmodel, params, load_model(WEIGHTS)[0]


def _images():
    """Gray images of three shapes (9 + 3 + 2, so partial batches and the
    flush of partial buckets) with sources; one key reads as None."""
    out = {}
    for i, s in enumerate([96] * 9 + [80] * 3 + [72] * 2):
        img = make_mosaic(s, s, n_sources=1 + i % 3, seed=50 + i,
                          **{k: v for k, v in CUTOUTS.items()
                             if k != "label"})[0]
        out[f"k{i:02d}"] = (img - img.min()) / (img.max() - img.min())
    out["k05"] = None                               # unreadable
    out["k07"] = np.full((96, 96), 0.5, np.float32)  # degenerate
    return out


def test_batched_detector_matches_jax(models):
    jmodel, params, tmodel = models
    imgs = _images()
    kw = dict(img_size=96, score_thr=0.3, batch_size=3)
    ref = JaxDetector(jmodel, params, compute_dtype=jnp.float32,
                      **kw).detect_many(list(imgs), imgs.get)
    det = BatchedDetector(tmodel, device="cpu", compute_dtype=torch.float32,
                          **kw)
    det.engine.recorder = recorder = Recorder()
    got = det.detect_many(list(imgs), imgs.get)
    assert set(got) == set(ref) == set(imgs)
    assert got["k05"] is None and ref["k05"] is None
    assert got["k07"][3] is False and ref["k07"][3] is False
    n = 0
    for key, r in ref.items():
        if r is None:
            continue
        assert got[key][3] == r[3], key
        assert catalog_mismatch(r[:3], got[key][:3]) is None, key
        n += len(r[1])
    assert n >= 10
    # the workers' staging spans, one a batch, summed across threads
    stage = [sp for sp in recorder.spans if sp.name == "engine.stage"]
    assert len(stage) == len([sp for sp in recorder.spans
                              if sp.name == "engine.dispatch"]) > 1
    assert recorder.totals()["engine.stage"] > 0


def test_update_params_swaps_weights_without_touching_the_model(models):
    """update_params copies, folds and casts the given model: the caller's
    modules keep their dtype and values, and the engine then gives what a
    new engine on those weights gives."""
    _, _, tmodel = models
    other = load_model(WEIGHTS)[0]
    with torch.no_grad():
        for p in other.parameters():
            p.mul_(0.9)
    before = {k: v.clone() for k, v in other.state_dict().items()}
    tiles = np.stack([v[..., None] for k, v in _images().items()
                      if v is not None and v.shape == (96, 96)][:4])
    engine = port_engine.TileEngine(tmodel, device="cpu", img_size=96,
                                    score_thr=0.05)
    engine.update_params(other)
    for k, v in other.state_dict().items():
        assert v.dtype == before[k].dtype and torch.equal(v, before[k]), k
    fresh = port_engine.TileEngine(other, device="cpu", img_size=96,
                                   score_thr=0.05)
    for a, b in zip(engine.process(tiles), fresh.process(tiles)):
        np.testing.assert_array_equal(a, b)


def test_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedDetector(load_model(WEIGHTS)[0])


# -- the CLIs against the JAX CLIs ---------------------------------------------

@pytest.fixture
def f32_engines(monkeypatch):
    """Both packages' engines and predictors default to f32, and so does
    the model the port's cli.run prepares from npz weights, so that the
    CLIs (which have no dtype flag) are held by the catalog rule."""
    monkeypatch.setenv("CAESAR_YOLO_NO_COMPILE_CACHE", "1")
    for cls, f32 in ((jax_engine.TileEngine, jnp.float32),
                     (jax_predictor.Predictor, jnp.float32),
                     (port_engine.TileEngine, torch.float32),
                     (port_predictor.Predictor, torch.float32)):
        monkeypatch.setitem(cls.__init__.__kwdefaults__, "compute_dtype", f32)
    monkeypatch.setattr(port_predictor, "COMPUTE_DTYPE", torch.float32)


def _dataset(root, n=7, sizes=(96, 96, 80)):
    """Labelled cutouts, a truncated FITS file and a constant one, and a
    filelist of all."""
    paths = write_labelled_cutouts(str(root), n, sizes=sizes, seed=70,
                                   **CUTOUTS)
    bad = os.path.join(str(root), "images", "trunc.fits")
    with open(paths[0], "rb") as f:
        data = f.read()
    with open(bad, "wb") as f:
        f.write(data[:4000])
    flat = os.path.join(str(root), "images", "flat.fits")
    from caesar_yolo_tpu_torch.utils.fits import write_fits
    write_fits(np.full((96, 96), 3.0, np.float32), flat)
    paths = paths[:3] + [bad] + paths[3:] + [flat]
    filelist = os.path.join(str(root), "list.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(paths) + "\n")
    return paths, filelist


def _detail_pairs(ref, got):
    assert [d["image"] for d in got] == [d["image"] for d in ref]
    for r, g in zip(ref, got):
        assert [x["label"] for x in g["gt"]] == [x["label"] for x in r["gt"]]
        arrays = []
        for d in (r, g):
            arrays.append((
                np.asarray([p["bbox"] for p in d["pred"]]).reshape(-1, 4),
                np.asarray([p["score"] for p in d["pred"]]),
                np.asarray([CLASS_NAMES.index(p["label"])
                            for p in d["pred"]])))
        assert catalog_mismatch(*arrays) is None, r["image"]
    return sum(len(d["pred"]) for d in ref)


@pytest.mark.parametrize("preproc", [[], ["--preprocessing",
                                          "--zscale_stretch",
                                          "--normalize_minmax"]],
                         ids=["raw", "readme"])
def test_cli_evaluate_matches_jax(tmp_path, capsys, f32_engines, preproc):
    """cli.evaluate prints the JAX CLI's C/R/F1 summary and writes the same
    per-image matches (detections by the catalog rule) on cutouts of two
    shapes with an unreadable and a constant image."""
    _, filelist = _dataset(tmp_path / "d")
    common = [f"--weights={WEIGHTS}", f"--filelist={filelist}",
              "--imgsize=96", "--batch_size=3", *preproc]
    rdetail, gdetail = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    assert jax_cli_evaluate.main([*common, f"--save_detail={rdetail}"]) == 0
    ref_out = capsys.readouterr().out
    rc, report = cli_evaluate.run([*common, f"--save_detail={gdetail}",
                                   "--devices=cpu"])
    assert rc == 0
    assert capsys.readouterr().out == ref_out
    with open(rdetail) as f:
        ref = json.load(f)
    with open(gdetail) as f:
        got = json.load(f)
    assert len(ref) == 8                 # the truncated file is skipped
    assert _detail_pairs(ref, got) >= 8
    assert np.isfinite(report.map.map50_95)
    if not preproc:    # the distribution the fixture was trained on
        assert report.completeness["compact"].n_matched >= 8


def test_cli_evaluate_refuses_unported_flags(tmp_path):
    """Nothing is refused any more: --save_plot writes the per-class C/R/F1
    figure and the PR curves beside it (as the JAX package names them),
    and --int8 evaluates (calibrated on the first filelist image) and finds
    the float run's sources."""
    for w in ("w.pt", WEIGHTS):
        args = cli_evaluate.parse_args([f"--weights={w}", "--filelist=l.txt",
                                        "--int8", "--save_plot=p.png"])
        assert args.int8 and args.save_plot == "p.png"
    paths, filelist = _dataset(tmp_path / "d", n=4, sizes=(96,))
    common = [f"--weights={WEIGHTS}", f"--filelist={filelist}",
              "--imgsize=96", "--devices=cpu", "--batch_size=3"]
    reports = [cli_evaluate.run([*common, *extra])[1]
               for extra in ([], ["--int8"])]
    assert reports[0].completeness["compact"].n_matched >= 4
    assert reports[1].completeness["compact"].n_matched >= \
        reports[0].completeness["compact"].n_matched - 1
    pytest.importorskip("matplotlib")
    plot = tmp_path / "p.png"
    assert cli_evaluate.run([*common, f"--save_plot={plot}"])[0] == 0
    for p in (plot, tmp_path / "p_pr.png"):
        assert p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", p


def _run_in(path, fn, argv):
    cwd = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        return fn(argv)
    finally:
        os.chdir(cwd)


def _json_arrays(path):
    with open(path) as f:
        cat = json.load(f)
    objs = cat.get("objs", cat.get("sources"))
    return (np.asarray([[o["x1"], o["y1"], o["x2"], o["y2"]]
                        for o in objs]).reshape(-1, 4),
            np.asarray([o["score"] for o in objs]),
            np.asarray([o["class_id"] for o in objs]),
            np.asarray([o["edge"] for o in objs]))


@pytest.mark.parametrize("route", ["batched", "serial", "tiled"])
def test_cli_run_datalist_matches_jax(tmp_path, f32_engines, route):
    """cli.run --datalist through each route of the JAX CLI writes the same
    files with the same catalogs (by the catalog rule, edge flags equal)
    and the same exit code: 1 with an unreadable and a degenerate image,
    except tiled, where failed tile reads are skipped and a degenerate
    image's tiles give an empty catalog."""
    # one tile shape: the JAX engine compiles once per shape
    paths, filelist = _dataset(tmp_path / "d", n=5, sizes=(
        (96,) if route == "tiled" else (96, 96, 80)))
    argv = [f"--datalist={filelist}", f"--weights={WEIGHTS}",
            "--imgsize=96", "--scoreThr=0.3", "--batch_size=3"]
    if route == "serial":
        argv.append("--detect_outfile_json=cat.json")
    if route == "tiled":
        argv += ["--split_img_in_tiles", "--tile_xsize=48",
                 "--tile_ysize=48"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    rc_ref = _run_in(jdir, jax_cli_run.main, argv)
    rc_got = _run_in(tdir, cli_run.main, argv + ["--devices=cpu"])
    rc = 0 if route == "tiled" else 1
    assert (rc_got, rc_ref) == (rc, rc)
    ref = sorted(os.path.basename(p) for p in glob.glob(f"{jdir}/*.json")
                 + glob.glob(f"{jdir}/*.reg"))
    got = sorted(os.path.basename(p) for p in glob.glob(f"{tdir}/*.json")
                 + glob.glob(f"{tdir}/*.reg"))
    assert got == ref
    n_json = 0
    for name in ref:
        if name.endswith(".json"):
            r = _json_arrays(os.path.join(jdir, name))
            assert catalog_mismatch(r, _json_arrays(
                os.path.join(tdir, name))) is None, name
            n_json += 1
        else:
            with open(os.path.join(jdir, name)) as f, \
                    open(os.path.join(tdir, name)) as g:
                assert len(f.readlines()) == len(g.readlines()), name
    assert n_json == (len(paths) if route == "tiled" else len(paths) - 2)


# -- validation during training ------------------------------------------------

def test_cli_train_validates_and_keeps_best_across_resume(tmp_path,
                                                          monkeypatch):
    """cli.train with --val_data validates after each epoch but the last
    and once after the final precise-BN, writes `best` at the best metric,
    keeps that metric in every later checkpoint, and a --resume from a
    checkpoint written after a validation starts from its best_metric."""
    from caesar_yolo_tpu_torch.cli import train as cli_train
    from caesar_yolo_tpu_torch.train.trainer import Trainer
    train_dir, val_dir = tmp_path / "train", tmp_path / "val"
    write_labelled_cutouts(str(train_dir), 4, sizes=(48,), seed=1, label=1)
    write_labelled_cutouts(str(val_dir), 3, sizes=(48, 40), seed=9, label=1)
    reports = []
    real = evaluation.evaluate_dataset

    def spy(*args, **kwargs):
        reports.append(real(*args, **kwargs))
        return reports[-1]

    monkeypatch.setattr(evaluation, "evaluate_dataset", spy)
    ck = str(tmp_path / "ck")
    args = [f"--data={train_dir / 'images'}", "--devices=cpu",
            "--model=yolo11n", "--imgsz=64", "--batch=2", "--fp32",
            f"--checkpoint_dir={ck}", "--checkpoint_every=1", "--max_gt=4",
            f"--val_data={val_dir / 'images'}", "--val_every=1",
            "--val_score_thr=0.001", "--no_augment"]
    rc, trainer = cli_train.run(args + ["--epochs=2"])
    assert rc == 0 and len(reports) == 2
    metrics = []
    for r in reports:
        f1 = r.f1.get("source", 0.0)
        metrics.append(f1 if np.isfinite(f1) else 0.0)
        assert r.completeness["source"].n == 6    # 1 + 2 + 3 sources
    best = Trainer.load_checkpoint(os.path.join(ck, "best"))
    assert best["best_metric"] == max(metrics) == trainer.best_metric
    step2 = Trainer.load_checkpoint(os.path.join(ck, "step_2"))
    assert step2["best_metric"] == metrics[0]     # the epoch-1 validation
    with open(os.path.join(ck, "best.step")) as f:
        best_step = int(f.read())

    reports.clear()
    rc, trainer = cli_train.run(args + ["--epochs=3",
                                        f"--resume={ck}/step_2"])
    assert rc == 0 and len(reports) == 1 and trainer.step == 6
    f1 = reports[0].f1.get("source", 0.0)
    resumed = f1 if np.isfinite(f1) else 0.0
    assert trainer.best_metric == max(metrics[0], resumed)
    with open(os.path.join(ck, "best.step")) as f:
        rewritten = int(f.read()) != best_step
    assert rewritten == (resumed > metrics[0])
    last = Trainer.load_checkpoint(os.path.join(ck, "last"))
    assert last["best_metric"] == trainer.best_metric
