"""The port's int8 PTQ (models/quant.py, the int8 layer, kernel K9's plain
version and its design) against the JAX package on the CPU.

Rules, each measured on these inputs:
  - the quantized convs, wq and ws equal JAX's exactly on equal fused
    weights; xs within 1e-5 relative from f32 calibration (measured
    1.2e-6: the port's f32 forward is within ulps of XLA's) and within
    4e-2 from bf16 calibration (measured 0 on both models since the
    port's bf16 inference takes the reference's arithmetic, one rounding
    after the f32 bias and its SiLU; 3.0e-2 on the trained fixture
    before).  That rule cannot tell a calibration in f32 or on the
    unfused model from the right one: their xs land as near JAX's bf16
    ones.  The calibration's model and dtype are checked directly
    instead;
  - the int8 forward in f32 on JAX's quantized params carried across:
    raw head outputs within 1e-4 (measured 2.9e-6: XLA may contract the
    dequantize's multiply-add into an FMA);
  - catalogs of the CLIs in f32 (engines and calibration both f32) by the
    bf16 rule of tests/test_torch_engine.py (each detection clear of the
    threshold by 0.03 has a same-class partner with IoU >= 0.5 and a score
    within 0.025), not the catalog rule: int8 is discontinuous, and an
    ulp between the port's f32 preprocessing or convs and XLA's flips xq
    where x / xs lies at a round tie.  Recorded case: the two-source
    192 px mosaic of test_cli_run_int8_matches_jax[tiled] (conftest's rng,
    seed 42), JAX's own quantized params carried into the port's CLI:
    JAX's scores 0.9522, 0.9562, 0.4685, 0.3150, the port's 0.9507,
    0.9562, 0.4721, 0.3156, the first box 1 px wider (IoU 0.947); with
    the port's own calibration (xs within 1.2e-6) one more detection, at
    0.3004 against the 0.3 threshold;
  - K9's design emulated on the CPU (the padded int8 copy, its tiles,
    tap-by-tap K order, wgmma steps and address arithmetic) equals
    qconv_plain bit for bit (torch.equal).
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import caesar_yolo_tpu.detect.predictor as jax_predictor
import chip_smoke as cs
import caesar_yolo_tpu.parallel.engine as jax_engine
from caesar_yolo_tpu.cli import evaluate as jax_cli_evaluate
from caesar_yolo_tpu.cli import run as jax_cli_run
from caesar_yolo_tpu.models import quant as jquant
from caesar_yolo_tpu.models.convert import _flatten
from caesar_yolo_tpu.models.convert import load_params as jload_params
from caesar_yolo_tpu.models.layers import Conv as JConv
from caesar_yolo_tpu.models.yolo import build_model as jbuild_model
from caesar_yolo_tpu.models.yolo import init_params
from caesar_yolo_tpu_torch.cli import evaluate as cli_evaluate
from caesar_yolo_tpu_torch.cli import run as cli_run
from caesar_yolo_tpu_torch.detect import predictor as port_predictor
from caesar_yolo_tpu_torch.detect.predictor import Predictor, prepare_model
from caesar_yolo_tpu_torch.models import cuda_qconv, quant
from caesar_yolo_tpu_torch.models.convert import (load_jax_params,
                                                  load_model, save_params)
from caesar_yolo_tpu_torch.models.layers import Conv, Conv2dRaw, silu
from caesar_yolo_tpu_torch.models.yolo import (DWConv, build_model,
                                               init_weights)
from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
from caesar_yolo_tpu_torch.parallel import engine as port_engine
from caesar_yolo_tpu_torch.utils.boxes import iou_matrix_np
from caesar_yolo_tpu_torch.utils.fits import write_fits
from caesar_yolo_tpu_torch.utils.synth import write_labelled_cutouts

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "yolov8n_synth96.npz")
XS_RTOL = {"f32": 1e-5, "bf16": 4e-2}
RAW_ATOL = 1e-4
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def two_source_image(rng, size=96, centres=((30, 30), (70, 62))):
    """tests/test_quant.py's image: noise and two bright round sources."""
    img = rng.normal(0.0, 0.08, (size, size)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for cx, cy in centres:
        img += 6.0 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                            / (2 * 4.5 ** 2)).astype(np.float32)
    return img


def jax_and_port(name, trained=False):
    if trained:
        params, meta = jload_params(FIXTURE)
        name = meta["model"]
    else:
        params = jax.device_get(init_params(
            jbuild_model(name, num_classes=5), 0))
    jm = jbuild_model(name, num_classes=5)
    return jm, params, load_jax_params(build_model(name, num_classes=5),
                                       params)


def nchw(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).permute(
        0, 3, 1, 2).to(dtype)


def cal_image(trained):
    if trained:
        img = two_source_image(np.random.default_rng(42))
        img = (img - img.min()) / (img.max() - img.min())
        return np.repeat(img[None, :, :, None], 3, -1)
    return np.random.default_rng(0).random((2, 64, 64, 3), np.float32)


# -- the scheme against JAX's -------------------------------------------------


@pytest.mark.parametrize("name,trained", [("yolov8n", True),
                                          ("yolo11n", False)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantization_matches_jax(name, trained, dt):
    """The same dense convs quantized, wq and ws equal on equal fused
    weights, xs by the calibration dtype's rule."""
    jm, params, pm = jax_and_port(name, trained)
    x = cal_image(trained)
    jdt, tdt = DTYPES[dt]
    qp = jax.device_get(jquant.quantize_model(jm, params,
                                              [jnp.asarray(x).astype(jdt)]))
    qm = quant.quantize_model(pm, [nchw(x, tdt)])
    jflat = dict(_flatten(qp))
    state = qm.state_dict()
    jq = sorted(k[:-3] for k in jflat if k.endswith("/wq"))
    tq = sorted(k[:-3].replace(".", "/") for k in state if k.endswith(".wq"))
    assert jq == tq and len(jq) > 30
    worst = max(abs(float(state[k.replace("/", ".") + ".xs"])
                    - float(jflat[k + "/xs"])) / float(jflat[k + "/xs"])
                for k in jq)
    assert worst <= XS_RTOL[dt], worst
    # on equal fused weights (JAX's, carried across; XLA folds BN with an
    # rsqrt, an ulp from the port's division) wq, ws and b are equal
    fp = jax.device_get(jax_engine.fuse_model_params(jm, params))
    qp = jax.device_get(jquant.quantize_model(
        jm, fp, [jnp.asarray(x).astype(jdt)], fused=True))
    qm = quant.quantize_model(
        load_jax_params(build_model(name, num_classes=5), fp),
        [nchw(x, tdt)])
    jflat = dict(_flatten(qp))
    state = qm.state_dict()
    for k in jq:
        t = k.replace("/", ".")
        np.testing.assert_array_equal(
            state[t + ".wq"].numpy(),
            np.asarray(jflat[k + "/wq"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(state[t + ".ws"].numpy(),
                                      np.asarray(jflat[k + "/ws"]))
        np.testing.assert_array_equal(state[t + ".b"].numpy(),
                                      np.asarray(jflat[k + "/b"]))


@pytest.mark.parametrize("name,trained", [("yolov8n", True),
                                          ("yolo11n", False)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_calibration_runs_fused_in_the_inputs_dtype(name, trained, dt,
                                                    monkeypatch):
    """The ranges come from the fused model run in the calibration inputs'
    dtype: every Conv the calibration forwards reach has its BN folded and
    sees inputs and weights of that dtype, and each int8 conv's xs is the
    largest |input| its calibration copy saw, over 127.  JAX's bf16 xs
    cannot show this: calibrating in f32 or on the unfused model lands as
    near them as the port's own calibration (PERF.md §6)."""
    _, _, pm = jax_and_port(name, trained)
    tdt = DTYPES[dt][1]
    copies, seen = [], {}
    cast = quant.cast_weights
    forward = Conv.forward

    def cast_spy(module, dtype):
        copies.append(module)
        return cast(module, dtype)

    def forward_spy(self, x):
        if self.calib is not None:
            amax = float(x.float().abs().amax())
            seen.setdefault(self, []).append(
                (self.bn is None, x.dtype, self.w.dtype, amax))
        return forward(self, x)

    monkeypatch.setattr(quant, "cast_weights", cast_spy)
    monkeypatch.setattr(Conv, "forward", forward_spy)
    qm = quant.quantize_model(pm, [nchw(cal_image(trained), tdt)])
    (cal,) = copies
    names = {m: n for n, m in cal.named_modules()}
    assert seen and all(rec[:3] == (True, tdt, tdt)
                        for recs in seen.values() for rec in recs)
    amax = {names[m]: max(rec[3] for rec in recs) for m, recs in seen.items()}
    int8 = {n: m for n, m in qm.named_modules()
            if isinstance(m, Conv) and m.wq is not None}
    assert len(int8) > 30 and set(int8) <= set(amax)
    for n, m in int8.items():
        assert float(m.xs) == np.float32(max(amax[n], 1e-12) / 127.0), n


@pytest.mark.parametrize("name,trained", [("yolov8n", True),
                                          ("yolo11n", False)])
def test_int8_forward_matches_jax_on_carried_params(name, trained):
    """JAX's quantized params carried across (convert.load_jax_params):
    the f32 int8 forwards agree within RAW_ATOL."""
    jm, params, _ = jax_and_port(name, trained)
    x = cal_image(trained)
    qp = jax.device_get(jquant.quantize_model(jm, params, [jnp.asarray(x)]))
    qm = load_jax_params(build_model(name, num_classes=5), qp)
    assert sum(isinstance(m, Conv) and m.wq is not None
               for m in qm.modules()) > 30
    tm = prepare_model(qm, dtype=torch.float32,
                       device=torch.device("cpu"))
    with torch.inference_mode():
        got = tm(nchw(x, torch.float32))
    ref = jm(qp, jnp.asarray(x))
    for (rb, rc), (gb, gc) in zip(ref, got):
        for r, g in ((rb, gb), (rc, gc)):
            r = np.asarray(r).transpose(0, 3, 1, 2)
            assert np.abs(g.numpy() - r).max() <= RAW_ATOL


def test_quantized_model_saves_and_loads(tmp_path):
    """save_params of an int8 model writes JAX's quantized tree (wq int8
    HWIO); both packages load it, and the port's reload is the same model."""
    jm, params, pm = jax_and_port("yolov8n", trained=True)
    x = cal_image(True)
    qm = quant.quantize_model(pm, [nchw(x, torch.float32)])
    path = save_params(qm, str(tmp_path / "q.npz"),
                       meta={"model": "yolov8n", "num_classes": 5})
    jparams, _ = jload_params(path)
    leaves = dict(_flatten(jparams))
    wqs = [v for k, v in leaves.items() if k.endswith("/wq")]
    assert len(wqs) > 30
    assert all(v.dtype == np.int8 and v.ndim == 4 for v in wqs)
    back, _ = load_model(path)
    for k, v in qm.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    tm = prepare_model(back, dtype=torch.float32,
                       device=torch.device("cpu"))
    with torch.inference_mode():
        got = tm(nchw(x, torch.float32))
    for (rb, rc), (gb, gc) in zip(jm(jparams, jnp.asarray(x)), got):
        assert np.abs(gc.numpy()
                      - np.asarray(rc).transpose(0, 3, 1, 2)).max() \
            <= RAW_ATOL


def test_calibration_inputs_match_jax():
    """calibration_inputs_from_tiles: gray -> 3 channels, the pipeline,
    letterbox, dtype, as JAX's (NHWC there, NCHW here)."""
    rng = np.random.default_rng(3)
    tiles = rng.normal(0, 1, (3, 80, 80, 1)).astype(np.float32)
    from caesar_yolo_tpu.ops import build_preprocessor as jbuild_pre
    ref = jquant.calibration_inputs_from_tiles(
        tiles, preprocessor=jbuild_pre(zscale_stretch=True,
                                       normalize_minmax=True),
        img_size=96, compute_dtype=jnp.float32)[0]
    got = quant.calibration_inputs_from_tiles(
        tiles, preprocessor=build_preprocessor(zscale_stretch=True,
                                               normalize_minmax=True),
        img_size=96, compute_dtype=torch.float32, device="cpu")[0]
    assert got.shape == (3, 3, 96, 96)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-6)


# -- twins of tests/test_quant.py ---------------------------------------------


def test_quantized_conv_close_to_float(rng):
    jconv = JConv(16, 32, 3)
    jp = jconv.init(jax.random.PRNGKey(0))
    conv = Conv(16, 32, 3)
    with torch.no_grad():
        conv.w.copy_(torch.from_numpy(
            np.asarray(jp["w"]).transpose(3, 2, 0, 1).copy()))
        conv.bn.mean.copy_(torch.from_numpy(
            rng.normal(0, 0.1, (32,)).astype(np.float32)))
        conv.bn.var.copy_(torch.from_numpy(
            (rng.random(32) + 0.5).astype(np.float32)))
    conv.eval().fuse()
    x = torch.from_numpy(rng.normal(0, 1, (2, 16, 24, 24)).astype(np.float32))
    with torch.no_grad():
        ref = conv(x)
        conv.to_int8(*quant.quantize_weights(conv.w, float(x.abs().max())))
        got = conv(x)
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    assert err < 0.02 * scale, f"quant error {err} vs range {scale}"


def test_quantize_model_skip_rules(rng):
    model = init_weights(build_model("yolo11n", num_classes=5), seed=0)
    xx = [torch.from_numpy(rng.random((1, 3, 64, 64), np.float32))]
    q = quant.quantize_model(model, xx)
    convs = [m for m in q.modules() if isinstance(m, (Conv, Conv2dRaw))]
    n_q = sum(isinstance(m, Conv) and m.wq is not None for m in convs)
    n_f = sum(m.w is not None for m in convs)
    assert n_q > 30, f"only {n_q} convs quantized"
    assert n_f > 0, "depthwise/head-final convs must stay float"
    for m in q.modules():
        if isinstance(m, Conv) and m.wq is not None:
            assert m.wq.dtype == torch.int8 and m.w is None
        if isinstance(m, (DWConv, Conv2dRaw)):
            assert m.w is not None
    dw = [m for m in q.head.modules() if isinstance(m, DWConv)]
    assert dw and all(getattr(m, "wq", None) is None for m in dw)
    # the caller's model is left as it was
    assert all(m.wq is None and m.bn is not None for m in model.modules()
               if isinstance(m, Conv))


def test_quantized_forward_runs_all_models(rng):
    for name in ("yolov8n", "yolo11n"):
        model = init_weights(build_model(name, num_classes=5), seed=0)
        xx = [torch.from_numpy(rng.random((1, 3, 64, 64), np.float32))]
        q = prepare_model(quant.quantize_model(model, xx),
                          dtype=torch.float32, device=torch.device("cpu"))
        with torch.inference_mode():
            for box, _ in q(xx[0]):
                assert torch.isfinite(box.float()).all()


def test_quantized_detection_quality(rng):
    """Trained detector, f32 vs int8: the same sources at matching
    positions (the PTQ quality gate)."""
    model, _ = load_model(FIXTURE)
    pipe = build_preprocessor(normalize_minmax=True)
    tile = two_source_image(rng)[..., None]
    prepped, ok = pipe.apply_batch(torch.from_numpy(tile)[None])
    assert bool(ok[0])
    inp = np.repeat(prepped[0].numpy(), 3, axis=-1)
    pf = Predictor(model, img_size=96, score_thr=0.3,
                   compute_dtype=torch.float32, device="cpu")
    bf, sf, cf = pf.predict_image(inp)
    calib = quant.calibration_inputs_from_tiles(
        tile[None], preprocessor=pipe, img_size=96,
        compute_dtype=torch.float32, device="cpu")
    pq = Predictor(quant.quantize_model(model, calib), img_size=96,
                   score_thr=0.3, compute_dtype=torch.float32,
                   device="cpu")
    bq, sq, cq = pq.predict_image(inp)
    assert len(bf) == 2, "float baseline must find both sources"
    assert len(bq) == len(bf), f"int8 found {len(bq)} vs f32 {len(bf)}"
    iou = iou_matrix_np(np.asarray(bf, float), np.asarray(bq, float))
    assert (iou.max(axis=1) >= 0.85).all(), f"boxes moved: {iou}"
    np.testing.assert_array_equal(np.sort(cf), np.sort(cq))
    assert np.abs(np.sort(sf) - np.sort(sq)).max() < 0.1


def _held_out(n, shift=0.0, drop=None):
    """n cutouts' merged detections (two sources each), the scores of the
    first `shift[1]` cutouts moved by shift[0]; the cutout `drop` loses a
    detection."""
    dets = []
    for i in range(n):
        boxes = np.array([[10.0, 10, 30, 30], [50, 50, 80, 70]]) + i % 7
        scores = np.array([0.9, 0.6])
        labels = ["compact", "extended"]
        if shift and i < shift[1]:
            scores = scores - shift[0]
        if i == drop:
            boxes, scores, labels = boxes[:1], scores[:1], labels[:1]
        dets.append({"bboxes": boxes, "scores": scores, "labels": labels})
    return dets


@pytest.mark.parametrize("case,mf1,shift,drop,misses", [
    ("equal", 0.7, 0.0, None, None),
    ("drop within", 0.685, 0.0, None, None),
    ("scores within", 0.7, (0.05, cs.QUALITY5_EVAL), None, None),
    ("one count", 0.7, 0.0, 3, None),
    ("macro-F1", 0.675, 0.0, None, "macro-F1"),
    ("scores", 0.7, (0.2, cs.QUALITY5_EVAL - cs.INT8_RULE_HELD + 1), None,
     "per-image rule"),
])
def test_int8_limits(case, mf1, shift, drop, misses):
    """chip_smoke.int8_miss, the card's int8-against-bf16 limits: macro-F1
    at most INT8_MF1_DROP below bf16's, and the JAX quality test's
    per-image rule holding on at least INT8_RULE_HELD held-out cutouts."""
    n = cs.QUALITY5_EVAL
    bf16 = (0.7, _held_out(n))
    why, held, fails = cs.int8_miss(bf16, (mf1, _held_out(n, shift, drop)))
    assert (why is None) == (misses is None), why
    assert misses is None or misses in why
    assert held == n - sum(fails.values())
    if drop is not None:
        assert fails == {"count": 1}


@pytest.mark.parametrize("part", [None, "count", "iou", "class", "score"])
def test_quality_rule_parts(part):
    """chip_smoke.quality_rule_failure names the first part of the JAX
    quality test's per-image rule that two detection sets miss."""
    a = _held_out(1)[0]
    b = {k: (v.copy() if isinstance(v, np.ndarray) else list(v))
         for k, v in a.items()}
    if part == "count":
        b = _held_out(1, drop=0)[0]
    elif part == "iou":
        b["bboxes"][1] += 4.0
    elif part == "class":
        b["labels"][0] = "flagged"
    elif part == "score":
        b["scores"][0] -= 1.5 * cs.INT8_SCORE_TOL
    assert cs.quality_rule_failure(a, b) == part


def _mosaic192(rng, path):
    img = rng.normal(0.0, 0.08, (192, 192)).astype(np.float32)
    yy, xx = np.mgrid[0:192, 0:192]
    for cx, cy in [(48, 48), (144, 144)]:
        img += 6.0 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                            / (2 * 4.5 ** 2)).astype(np.float32)
    write_fits(img, str(path))
    return str(path)


INT8_TILED = ["--int8", "--imgsize=96", "--scoreThr=0.3", "--preprocessing",
              "--normalize_minmax", "--split_img_in_tiles",
              "--tile_xsize=96", "--tile_ysize=96", "--tile_xstep=0.75",
              "--tile_ystep=0.75", "--batch_size=8"]


def test_cli_int8_detects_sources(tmp_path, monkeypatch, rng):
    """--int8 end to end: tiled detection on a synthetic mosaic finds the
    planted sources through the quantized engine."""
    path = _mosaic192(rng, tmp_path / "m.fits")
    monkeypatch.chdir(tmp_path)
    assert cli_run.main([f"--image={path}", f"--weights={FIXTURE}",
                         "--devices=cpu", *INT8_TILED]) == 0
    cat = json.loads((tmp_path / "catalog_m.json").read_text())
    assert len(cat["sources"]) >= 2


# -- the CLIs against the JAX CLIs --------------------------------------------


@pytest.fixture
def f32_int8(monkeypatch):
    """Both packages' engines, predictors and calibration inputs default to
    f32, so that the CLIs (which have no dtype flag) are held by the
    catalog rule."""
    monkeypatch.setenv("CAESAR_YOLO_NO_COMPILE_CACHE", "1")
    for fn, f32 in ((jax_engine.TileEngine.__init__, jnp.float32),
                    (jax_predictor.Predictor.__init__, jnp.float32),
                    (jquant.calibration_inputs_from_tiles, jnp.float32),
                    (port_engine.TileEngine.__init__, torch.float32),
                    (port_predictor.Predictor.__init__, torch.float32),
                    (quant.calibration_inputs_from_tiles, torch.float32)):
        monkeypatch.setitem(fn.__kwdefaults__, "compute_dtype", f32)


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
            np.asarray([o.get("edge", False) for o in objs]))


# the bf16 rule (tests/test_torch_engine.py), for the int8 CLIs
INT8_MARGIN, INT8_IOU, INT8_SCORE_TOL = 0.03, 0.5, 0.025


def _unpartnered(a, b, thr):
    """Detections of a (boxes, scores, classes) scoring >= thr with no
    partner in b by the rule above."""
    lonely = []
    for j in np.nonzero(a[1] >= thr)[0]:
        iou = iou_matrix_np(a[0][j:j + 1], b[0].reshape(-1, 4))[0]
        if not ((iou >= INT8_IOU) & (b[2] == a[2][j])
                & (np.abs(b[1] - a[1][j]) <= INT8_SCORE_TOL)).any():
            lonely.append((a[0][j], float(a[1][j])))
    return lonely


def assert_int8_match(ref, got, score_thr, what):
    thr = score_thr + INT8_MARGIN
    assert not _unpartnered(ref, got, thr), (what, _unpartnered(ref, got,
                                                                thr))
    assert not _unpartnered(got, ref, thr), (what, _unpartnered(got, ref,
                                                                thr))


def _same_outputs(jdir, tdir):
    ref = sorted(os.path.basename(p) for p in glob.glob(f"{jdir}/*.json"))
    got = sorted(os.path.basename(p) for p in glob.glob(f"{tdir}/*.json"))
    assert got == ref and ref
    n = 0
    for name in ref:
        r = _json_arrays(os.path.join(jdir, name))
        assert_int8_match(r, _json_arrays(os.path.join(tdir, name)), 0.3,
                          name)
        n += int((r[1] >= 0.3 + INT8_MARGIN).sum())
    return n


@pytest.mark.parametrize("route", ["tiled", "serial", "datalist"])
def test_cli_run_int8_matches_jax(tmp_path, f32_int8, rng, route):
    """cli.run --int8 (tiled on a mosaic, serially on it, and over a
    datalist calibrated on its first image) writes the JAX CLI's catalog
    files, their detections matched by the int8 CLI rule."""
    path = _mosaic192(rng, tmp_path / "m.fits")
    argv = [f"--weights={FIXTURE}", *INT8_TILED]
    if route != "tiled":
        argv = [a for a in argv if "tile" not in a]
    if route == "datalist":
        cut = write_labelled_cutouts(str(tmp_path / "d"), 3, sizes=(96,),
                                     seed=5, label=1, noise_sigma=0.08,
                                     amp_range=(3.0, 8.0),
                                     sigma_range=(3.0, 6.0))
        lst = tmp_path / "list.txt"
        lst.write_text("\n".join(cut) + "\n")
        argv.append(f"--datalist={lst}")
    else:
        argv.append(f"--image={path}")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert _run_in(jdir, jax_cli_run.main, argv) == 0
    assert _run_in(tdir, cli_run.main, argv + ["--devices=cpu"]) == 0
    assert _same_outputs(jdir, tdir) >= (2 if route != "datalist" else 3)


def test_cli_evaluate_int8_matches_jax(tmp_path, f32_int8, capsys):
    """cli.evaluate --int8, calibrated on the first filelist image: the
    JAX CLI's images, labels and detections (by the int8 CLI rule), and
    completeness and reliability within one detection of JAX's."""
    paths = write_labelled_cutouts(str(tmp_path / "d"), 6, sizes=(96, 80),
                                   seed=11, label=1, noise_sigma=0.08,
                                   amp_range=(3.0, 8.0),
                                   sigma_range=(3.0, 6.0))
    filelist = tmp_path / "list.txt"
    filelist.write_text("\n".join(paths) + "\n")
    common = [f"--weights={FIXTURE}", f"--filelist={filelist}",
              "--imgsize=96", "--batch_size=3", "--int8"]
    rd, gd = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    assert jax_cli_evaluate.main([*common, f"--save_detail={rd}"]) == 0
    ref_out = capsys.readouterr().out
    rc, report = cli_evaluate.run([*common, f"--save_detail={gd}",
                                   "--devices=cpu"])
    assert rc == 0
    with open(rd) as f, open(gd) as g:
        ref, got = json.load(f), json.load(g)
    assert [d["image"] for d in got] == [d["image"] for d in ref]
    n_ref = n_got = 0
    for r, g in zip(ref, got):
        assert [x["label"] for x in g["gt"]] == [x["label"] for x in r["gt"]]
        arrays = [(np.asarray([p["bbox"] for p in d["pred"]]).reshape(-1, 4),
                   np.asarray([p["score"] for p in d["pred"]]),
                   np.asarray([p["label"] == "compact" for p in d["pred"]]))
                  for d in (r, g)]
        assert_int8_match(*arrays, 0.25, r["image"])
        n_ref += len(arrays[0][1])
        n_got += len(arrays[1][1])
    assert abs(n_ref - n_got) <= 1 and "compact" in ref_out
    assert report.completeness["compact"].n_matched >= 6


# -- kernel K9: its plain version and its design ------------------------------


def k9_emulate(x, wq, ws, xs, b, stride, pad, act):
    """csrc/qconv.cu's design on the CPU: the quantize pass's padded int8
    copy [B, H, W, Cp] (quantize_padded_plain) and the packed weights
    [cout][k][k][Cp] (pack_weights); cuda_qconv.plan's tile: a block takes
    a tw x th rectangle of one image's output pixels (row p = ty * tw + tx
    of a 128-row M tile; rows past tw * th and pixels past Ho or Wo are
    computed but not stored) and bn output channels (those past cout are
    TMA's zeros); K is walked tap (r, s) by tap, each tap in groups of kb
    channels (those past Cp are zeros), the A rows gathered at the tap's
    offset with the conv's stride (image edges and padding are zeros);
    int products summed per wgmma (32 bytes of K); then the epilogue in
    the kernel's order into the channels_last output."""
    bsz, cin, h, w = x.shape
    cout, _, k, _ = wq.shape
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    tw, th, kb, bn = cuda_qconv.plan(h, w, cin, cout, k, stride)
    xq = cuda_qconv.quantize_padded_plain(x, xs).long()
    wp = cuda_qconv.pack_weights(wq).long()
    cp = xq.shape[-1]
    groups = -(-cp // kb)
    p = torch.arange(cuda_qconv.TILE_ROWS)
    out = torch.empty((bsz, ho, wo, cout), dtype=x.dtype)
    for img in range(bsz):
        for oy0 in range(0, ho, th):
            for ox0 in range(0, wo, tw):
                oy, ox = oy0 + p // tw, ox0 + p % tw
                row_ok = p < tw * th
                for n0 in range(0, cout, bn):
                    n = n0 + torch.arange(bn)
                    acc = torch.zeros((len(p), bn), dtype=torch.int64)
                    for tap in range(k * k):
                        r, s = divmod(tap, k)
                        iy = oy * stride - pad + r
                        ix = ox * stride - pad + s
                        inb = (row_ok & (iy >= 0) & (iy < h) & (ix >= 0)
                               & (ix < w))
                        for g in range(groups):
                            for ks in range(0, kb, 32):
                                c = g * kb + ks + torch.arange(32)
                                a = xq[img, iy.clamp(0, h - 1)[:, None],
                                       ix.clamp(0, w - 1)[:, None],
                                       c.clamp(max=cp - 1)[None]]
                                a = torch.where(inb[:, None]
                                                & (c < cp)[None], a, 0)
                                bt = wp[n.clamp(max=cout - 1)[:, None], r, s,
                                        c.clamp(max=cp - 1)[None]]
                                bt = torch.where((n < cout)[:, None]
                                                 & (c < cp)[None], bt, 0)
                                acc += a @ bt.T
                    assert acc.abs().max() < 2 ** 31
                    keep = row_ok & (oy < ho) & (ox < wo)
                    cols = slice(n0, min(n0 + bn, cout))
                    accv = acc[keep][:, :cols.stop - n0]
                    out[img, oy[keep], ox[keep], cols] = (
                        accv.float() * (ws * xs)[cols] + b[cols]).to(x.dtype)
    # SiLU over the whole output in qconv_plain's memory order: PyTorch's
    # CPU exp rounds its vectorised body and scalar tail apart
    out = out.permute(0, 3, 1, 2).contiguous()
    return silu(out) if act else out


def _shape_id(shape):
    return "x".join(str(v) for v in shape[:7]) + f"-{shape[7]}-{shape[8]}"


@pytest.mark.parametrize("act", [True, False], ids=["silu", "linear"])
@pytest.mark.parametrize("shape", cs.QCONV_SHAPES, ids=_shape_id)
def test_kernel_design_equals_plain(shape, act):
    """Over K9's parity shapes (chip_smoke.QCONV_SHAPES, which the card
    holds K9 to as well)."""
    k, stride, dtype = shape[5], shape[6], getattr(torch, shape[7])
    x, wq, ws, xs, bias = cs.qconv_case(torch, shape, "cpu", sum(shape[:7]))
    ref = cuda_qconv.qconv_plain(x, wq, ws, xs, bias, stride, k // 2, act)
    got = k9_emulate(x, wq, ws, xs, bias, stride, k // 2, act)
    assert got.dtype == ref.dtype == dtype
    assert torch.equal(got, ref)
    cuda_qconv.check_shapes(x, wq, ws, xs, bias, stride, k // 2)


def test_kernel_plan_takes_every_yolo11l_conv():
    """cuda_qconv.plan on every dense conv of yolo11l at 640 px (and
    QCONV_SHAPES): a tile the C entry takes (tw * th <= 128 rows, TMA boxes
    of at most 256 pixels a side, kb 32, 64 or 128 channels a stage and
    fewer than 64 of them past Cp, bn 64 or 128), rectangles inside the
    output, and at least 3/4 of the M rows used at every yolo11l conv."""
    model = build_model("yolo11l").eval()
    shapes, hooks = set(), []
    for m in model.modules():
        if isinstance(m, Conv) and m.groups == 1:
            hooks.append(m.register_forward_hook(
                lambda m, a, o: shapes.add((a[0].shape[2], a[0].shape[3],
                                            m.cin, m.cout, m.k, m.s))))
    with torch.no_grad():
        model(torch.zeros((1, 3, 640, 640)))
    for hk in hooks:
        hk.remove()
    assert len(shapes) >= 30
    yolo = set(shapes)
    shapes |= {(s[3], s[4], s[1], s[2], s[5], s[6]) for s in cs.QCONV_SHAPES}
    for h, w, cin, cout, k, stride in shapes:
        tw, th, kb, bn = cuda_qconv.plan(h, w, cin, cout, k, stride)
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        assert tw * th <= cuda_qconv.TILE_ROWS and tw <= wo and th <= ho
        assert tw * stride <= 256 and th * stride <= 256
        cp = cuda_qconv.padded_channels(cin)
        assert kb in (32, 64, 128) and -(-cp // kb) * kb - cp < 64
        assert bn == (64 if cout <= 64 else 128)
        used = ho * wo / (-(-ho // th) * -(-wo // tw) * cuda_qconv.TILE_ROWS)
        if (h, w, cin, cout, k, stride) in yolo:
            assert used >= 0.75, (h, w, cin, cout, used)


def test_plain_matches_jax_int8_conv():
    """qconv_plain in f32 against the JAX Conv's int8 branch on equal
    quantized params: within one f32 ulp of the output (XLA's FMA)."""
    jconv = JConv(24, 40, 3, 2)
    x, wq, ws, xs, bias = cs.qconv_case(
        torch, (2, 24, 40, 15, 15, 3, 2, "float32", "nchw"), "cpu", 7)
    params = {"wq": jnp.asarray(wq.permute(2, 3, 1, 0).numpy()),
              "ws": jnp.asarray(ws.numpy()), "xs": jnp.float32(float(xs)),
              "b": jnp.asarray(bias.numpy())}
    ref = np.asarray(jconv(params, jnp.asarray(x.permute(0, 2, 3, 1)
                                               .numpy())))
    got = cuda_qconv.qconv_plain(x, wq, ws, xs, bias, 2, 1, True)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=2e-6, atol=2e-6)


def test_kernel_refuses_what_it_does_not_take():
    x, wq, ws, xs, bias = cs.qconv_case(
        torch, (1, 8, 8, 6, 6, 3, 1, "float32", "nchw"), "cpu", 1)
    for bad in (dict(stride=3), dict(pad=0),
                dict(wq=wq[:, :, :2, :2].contiguous()),
                dict(x=x.double()), dict(wq=wq.float())):
        kw = dict(x=x, wq=wq, ws=ws, xs=xs, b=bias, stride=1, pad=1)
        kw.update(bad)
        with pytest.raises(ValueError):
            cuda_qconv.check_shapes(**kw)
    big = torch.zeros((1, 1, 1, 1), dtype=torch.int8).expand(
        1, cuda_qconv.MAX_K // 9 + 1, 3, 3)
    with pytest.raises(ValueError):
        cuda_qconv.check_shapes(torch.zeros((1, big.shape[1], 4, 4)), big,
                                torch.ones(1), xs, torch.ones(1), 1, 1)
