"""The port's ultralytics `.pt` path against the JAX package on the CPU:
the checkpoint reader (the ghost-module unpickler), the key mapping for
both Detect heads, the architecture-name rules, cli.convert's npz, `.pt`
weights in cli.run, and the ultralytics oracle (tests/ultra_ref.py) with
the Predictor's ultralytics options."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
import ultra_ref as U
from caesar_yolo_tpu.cli import convert as jax_cli_convert
from caesar_yolo_tpu.models import convert as jconv
from caesar_yolo_tpu.models.yolo import build_model as jax_build_model
from caesar_yolo_tpu.models.yolo import init_params
from caesar_yolo_tpu_torch.cli import convert as cli_convert
from caesar_yolo_tpu_torch.cli import run as cli_run
from caesar_yolo_tpu_torch.detect.predictor import Predictor
from caesar_yolo_tpu_torch.models import convert as pconv
from caesar_yolo_tpu_torch.models.yolo import build_model
from caesar_yolo_tpu_torch.utils.fits import write_fits
from test_pipeline_parity import (
    assert_catalogs_match,
    assert_order_consistent,
    convert_twin,
    jax_decode_conf,
    n_anchors,
    pick_iou_threshold,
    pick_threshold,
)

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
WEIGHTS = os.path.join(FIXTURES, "yolov8n_synth96.npz")


def ultralytics_sd(jm, params) -> dict[str, np.ndarray]:
    """The JAX params tree under ultralytics' checkpoint keys (OIHW), by
    reversing the JAX converter's layout rules, as
    tests/test_convert.py:_fake_state_dict does."""
    sd = {}

    def put_conv(prefix, p):
        sd[f"{prefix}.conv.weight"] = np.asarray(p["w"]).transpose(3, 2, 0, 1)
        for leaf, key in (("gamma", "weight"), ("beta", "bias"),
                          ("mean", "running_mean"), ("var", "running_var")):
            sd[f"{prefix}.bn.{key}"] = np.asarray(p["bn"][leaf])

    def put_raw(prefix, p):
        sd[f"{prefix}.weight"] = np.asarray(p["w"]).transpose(3, 2, 0, 1)
        sd[f"{prefix}.bias"] = np.asarray(p["b"])

    def walk(p, prefix):
        if "w" in p:
            (put_conv if "bn" in p else put_raw)(prefix, p)
            return
        for key, sub in p.items():
            if key == "m":
                for j, s in enumerate(sub):
                    walk(s, f"{prefix}.m.{j}")
            elif key in ("ffn1", "ffn2"):
                walk(sub, f"{prefix}.ffn.{int(key[-1]) - 1}")
            else:
                walk(sub, f"{prefix}.{key}")

    for i, spec in enumerate(jm.layers):
        if spec.name in params:
            walk(params[spec.name], f"model.{i}")
    hi = len(jm.layers)
    for lvl in range(3):
        box, cls = params["head"]["box"][lvl], params["head"]["cls"][lvl]
        put_conv(f"model.{hi}.cv2.{lvl}.0", box[0])
        put_conv(f"model.{hi}.cv2.{lvl}.1", box[1])
        put_raw(f"model.{hi}.cv2.{lvl}.2", box[2])
        if jm.head.legacy:
            prefixes = [f"cv3.{lvl}.0", f"cv3.{lvl}.1"]
        else:
            prefixes = [f"cv3.{lvl}.{a}.{b}" for a in (0, 1) for b in (0, 1)]
        for pre, p in zip(prefixes, cls):
            put_conv(f"model.{hi}.{pre}", p)
        put_raw(f"model.{hi}.cv3.{lvl}.2", cls[-1])
    # the fixed DFL kernel and BN step counters ride along in real files
    sd[f"model.{hi}.dfl.conv.weight"] = np.arange(16, dtype=np.float32
                                                  ).reshape(1, 16, 1, 1)
    sd["model.0.bn.num_batches_tracked"] = np.asarray(7)
    return sd


def write_pt(path, sd, epoch=3):
    """An ultralytics-style checkpoint of sd ({"model", "ema", "epoch"},
    its classes gone at load time), by chip_smoke's writer."""
    cs.save_ultralytics_pt(torch, str(path),
                           {k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, epoch=epoch)


@pytest.fixture(scope="module", params=["yolov8n", "yolo11n"])
def checkpoint(request, tmp_path_factory):
    """(name, JAX model, JAX params, ultralytics sd, .pt path)."""
    name = request.param
    jm = jax_build_model(name, num_classes=5)
    params = init_params(jm, seed=1)
    sd = ultralytics_sd(jm, params)
    path = tmp_path_factory.mktemp("pt") / f"{name}.pt"
    write_pt(path, sd)
    return name, jm, params, sd, path


def test_pt_state_dict_equals_the_jax_converter(checkpoint):
    """The port reads the checkpoint into a state_dict equal, key for key
    and bit for bit, to the JAX converter's params carried across."""
    name, jm, _, _, path = checkpoint
    ref = pconv.state_from_params(
        jconv.convert_state_dict(jconv.load_torch_state_dict(str(path)), jm))
    model, meta = pconv.convert_checkpoint(str(path))
    got = model.state_dict()
    assert meta == {"model": name, "num_classes": 5}
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], ref[k]), k


def test_pt_reader_equals_the_jax_reader(checkpoint):
    _, _, _, sd, path = checkpoint
    ref = jconv.load_torch_state_dict(str(path))
    got = pconv.load_torch_state_dict(str(path))
    assert list(got) == list(ref)
    assert set(got) == set(sd)
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k])


def test_chip_smoke_writer_uses_ultralytics_keys(checkpoint):
    """chip_smoke's own key map (port state -> ultralytics keys) gives the
    keys and tensors that reversing the JAX converter gives."""
    name, jm, params, sd, _ = checkpoint
    model = build_model(name)
    pconv.load_jax_params(model, params)
    got = cs.ultralytics_state(model)
    want = {k: v for k, v in sd.items()
            if ".dfl." not in k and not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_missing_key_raises(checkpoint):
    name, jm, _, sd, _ = checkpoint
    sd = dict(sd)
    del sd["model.0.conv.weight"]
    with pytest.raises(KeyError, match="model.0.conv.weight"):
        pconv.convert_state_dict(sd, build_model(name))
    with pytest.raises(KeyError):
        jconv.convert_state_dict(sd, jm)


def test_unused_keys_warn(checkpoint, monkeypatch):
    """Keys the mapping does not use are logged as a warning (the DFL
    kernel and BN step counters are expected and are not)."""
    name, _, _, sd, _ = checkpoint
    warned = []
    monkeypatch.setattr(pconv.logger, "warning",
                        lambda msg, *args: warned.append(msg % args))
    pconv.convert_state_dict(sd, build_model(name))
    assert warned == []
    sd = {**sd, "model.99.extra.weight": np.zeros(3, np.float32)}
    pconv.convert_state_dict(sd, build_model(name))
    assert warned == ["Converter: 1 unused checkpoint keys (first: "
                      "['model.99.extra.weight'])"]


def _ghost_module_pt(tmp_path):
    """A checkpoint whose model class lives in a module gone at load time
    (tests/test_convert.py's case)."""
    import types

    class FakeDetectionModel(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 1),
                                             torch.nn.BatchNorm2d(8))

    FakeDetectionModel.__module__ = "fake_ultralytics.nn.tasks"
    FakeDetectionModel.__qualname__ = "FakeDetectionModel"
    chain = ("fake_ultralytics", "fake_ultralytics.nn",
             "fake_ultralytics.nn.tasks")
    parent = None
    for name in chain:
        mod = types.ModuleType(name)
        sys.modules[name] = mod
        if parent is not None:
            setattr(parent, name.rsplit(".", 1)[1], mod)
        parent = mod
    parent.FakeDetectionModel = FakeDetectionModel
    try:
        m = FakeDetectionModel().eval()
        with torch.no_grad():
            m.model[0].weight.fill_(0.5)
        path = str(tmp_path / "ghost.pt")
        torch.save({"model": m, "epoch": 7}, path)
    finally:
        for name in chain:
            del sys.modules[name]
    return path


def _ema_pt(tmp_path):
    ma = torch.nn.Sequential(torch.nn.Conv2d(1, 2, 1))
    mb = torch.nn.Sequential(torch.nn.Conv2d(1, 2, 1))
    with torch.no_grad():
        ma[0].weight.fill_(1.0)
        mb[0].weight.fill_(2.0)
    path = str(tmp_path / "ema.pt")
    torch.save({"model": ma, "ema": mb}, path)
    return path


def _plain_pt(tmp_path):
    path = str(tmp_path / "sd.pt")
    torch.save({"model.0.conv.weight": torch.rand(16, 3, 3, 3,
                                                  dtype=torch.float64)}, path)
    return path


@pytest.mark.parametrize("case", ["ghost_classes", "prefers_ema",
                                  "plain_state_dict"])
def test_ghost_unpickler_cases(tmp_path, case):
    """Classes missing at load time become bare nn.Modules; `ema` is taken
    over `model`; a plain state_dict is read as it is: the port reads each
    file as the JAX converter does, in f32."""
    path = {"ghost_classes": _ghost_module_pt, "prefers_ema": _ema_pt,
            "plain_state_dict": _plain_pt}[case](tmp_path)
    ref = jconv.load_torch_state_dict(path)
    got = pconv.load_torch_state_dict(path)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], ref[k])
    if case == "ghost_classes":
        np.testing.assert_array_equal(got["model.0.weight"], 0.5)
        assert "model.1.running_mean" in got
    elif case == "prefers_ema":
        np.testing.assert_array_equal(got["0.weight"], 2.0)


@pytest.mark.parametrize("stem", ["yolov8l", "yolo11x", "yolov11m",
                                  "weights-yolov8l", "yolov8_yolo11l",
                                  "yolov11m_final", "yolo11best", "resnet50",
                                  "yolo11n_best", "yolov8"])
def test_infer_model_name_rules(stem):
    """The fullmatch-then-substring rules of the JAX converter."""
    assert pconv._infer_model_name(stem) == jconv._infer_model_name(stem)


def test_infer_num_classes():
    sd = {"model.22.cv3.0.2.bias": np.zeros(7), "model.22.cv3.1.2.bias":
          np.zeros(7), "model.0.conv.weight": np.zeros((1, 1, 1, 1))}
    for s in (sd, {"model.0.conv.weight": np.zeros((1, 1, 1, 1))}):
        assert pconv.infer_num_classes(s) == jconv.infer_num_classes(s)


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def test_cli_convert_writes_the_jax_npz(checkpoint, tmp_path):
    """cli.convert writes the JAX cli.convert's leaves and meta; the JAX
    load_params reads the port's file into the same tree."""
    name, _, _, _, path = checkpoint
    ref_path, got_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    assert jax_cli_convert.main([str(path), ref_path]) == 0
    assert cli_convert.main([str(path), got_path]) == 0
    ref, got = _npz(ref_path), _npz(got_path)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    params, meta = jconv.load_params(got_path)
    assert meta == {"model": name, "num_classes": 5}
    ref_params, _ = jconv.load_params(ref_path)
    import jax
    for a, b in zip(jax.tree_util.tree_leaves(ref_params),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_cli_convert_default_out_and_failures(tmp_path, checkpoint):
    """No out path: <stem>.npz beside the input.  A missing or corrupt .pt
    exits 1 with the error logged, as the JAX CLI does."""
    name, _, _, _, path = checkpoint
    src = tmp_path / f"weights-{name}.pt"
    src.write_bytes(path.read_bytes())
    assert cli_convert.main([str(src)]) == 0
    assert pconv.load_params(str(tmp_path / f"weights-{name}.npz"))[1] == {
        "model": name, "num_classes": 5}
    bad = tmp_path / "corrupt.pt"
    bad.write_bytes(b"PK\x03\x04 this is not a checkpoint")
    for p in (bad, tmp_path / "nope.pt"):
        assert jax_cli_convert.main([str(p)]) == 1
        assert cli_convert.main([str(p)]) == 1


def test_cli_run_pt_equals_npz(tmp_path, monkeypatch):
    """cli.run --devices=cpu with the fixture's weights as an ultralytics
    .pt writes the catalog it writes from the npz, value for value."""
    params, meta = jconv.load_params(WEIGHTS)
    jm = jax_build_model(meta["model"], num_classes=int(meta["num_classes"]))
    pt = tmp_path / "yolov8n_synth96.pt"
    write_pt(pt, ultralytics_sd(jm, params))
    with np.load(os.path.join(FIXTURES,
                              "torch_port_golden_mosaic_v8n96.npz")) as f:
        mosaic = f["mosaic"]
    image = str(tmp_path / "mosaic.fits")
    write_fits(mosaic, image)
    monkeypatch.chdir(tmp_path)
    cats = {}
    for w in (str(pt), WEIGHTS):
        out = str(tmp_path / f"{os.path.basename(w)}.json")
        assert cli_run.main([f"--image={image}", f"--weights={w}",
                             "--imgsize=96", "--devices=cpu",
                             "--scoreThr=0.3", "--preprocessing",
                             "--normalize_minmax",
                             f"--detect_outfile_json={out}"]) == 0
        with open(out) as f:
            cats[w] = json.load(f)
    assert len(cats[WEIGHTS]["objs"]) > 0
    assert cats[str(pt)] == cats[WEIGHTS]


@pytest.fixture(scope="module")
def dense_img():
    """tests/test_pipeline_parity.py's dense scene: 80 sources in 256 px,
    zscale + min-max (the JAX preprocessor), three channels."""
    from caesar_yolo_tpu.ops import build_preprocessor
    from caesar_yolo_tpu.utils.synth import make_mosaic
    data, _ = make_mosaic(nx=256, ny=256, n_sources=80, seed=5)
    img = np.repeat(data[:, :, None], 3, axis=-1)
    out, valid = build_preprocessor(zscale_stretch=True,
                                    normalize_minmax=True)(img)
    assert bool(valid)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("name,seed", [("yolov8n", 4), ("yolo11n", 2)])
def test_pt_matches_the_ultralytics_oracle(dense_img, tmp_path, name, seed):
    """A calibrated ultralytics twin (tests/ultra_ref.py) saved as a .pt
    and read by the port: its Predictor with input_scale=1/255 and
    channel_flip=True, in f32 on the CPU, matches ultra_pipeline (letterbox
    with 114, BGR->RGB, /255, forward, decode, NMS, scale_boxes) by the
    catalog rule, as tests/test_pipeline_parity.py holds the JAX
    Predictor."""
    img_size = 192
    lb, _, _, _ = U.ultra_letterbox(dense_img, img_size)
    t = torch.from_numpy(np.ascontiguousarray(
        lb[:, :, ::-1].transpose(2, 0, 1)))[None] / 255.0
    tm = U.build_torch_twin(name, seed=seed, calib=t)
    with torch.no_grad():
        raw = tm(t)
    boxes_all, scores_all = U.ultra_decode(raw)
    conf_thr = pick_threshold(scores_all)
    iou_thr = pick_iou_threshold(boxes_all, scores_all, conf_thr, 0.5)
    oracle = U.ultra_pipeline(tm, dense_img, img_size, conf_thr, iou_thr)
    jm, params = convert_twin(tm, name)
    assert_order_consistent(scores_all.max(axis=1),
                            jax_decode_conf(jm, params, dense_img, img_size),
                            conf_thr, boxes_all, scores_all, iou_thr)
    pt = tmp_path / f"{name}.pt"
    torch.save(tm.state_dict(), str(pt))
    model, _ = pconv.convert_checkpoint(str(pt))
    pred = Predictor(model, img_size=img_size, score_thr=conf_thr,
                     iou_thr=iou_thr, pre_nms=n_anchors(img_size),
                     compute_dtype=torch.float32, device="cpu",
                     input_scale=1 / 255.0, channel_flip=True)
    assert_catalogs_match(pred.predict_image(dense_img), oracle)


def test_predictor_ultralytics_options_match_jax():
    """input_scale=1 and channel_flip=False give the numbers of a
    Predictor without them; with input_scale=1/255 and channel_flip=True
    the port's Predictor matches the JAX one (pad PAD_VALUE / scale, flip,
    then scale) on 0-255 pixels by the catalog rule, in f32."""
    import jax.numpy as jnp

    from caesar_yolo_tpu.detect.predictor import Predictor as JaxPredictor
    from caesar_yolo_tpu_torch.utils.boxes import catalog_mismatch
    model, _ = pconv.load_model(WEIGHTS)
    params, meta = jconv.load_params(WEIGHTS)
    jm = jax_build_model(meta["model"], num_classes=int(meta["num_classes"]))
    from caesar_yolo_tpu_torch.utils.synth import make_mosaic
    data = make_mosaic(64, 80, n_sources=4, noise_sigma=0.08,
                       amp_range=(3.0, 8.0), sigma_range=(3.0, 6.0),
                       seed=3)[0]
    data = (data - data.min()) / (data.max() - data.min())
    img = np.stack([data, 0.9 * data, 0.8 * data], axis=-1)
    kw = dict(img_size=96, score_thr=0.05)
    base = Predictor(model, compute_dtype=torch.float32, device="cpu",
                     **kw).predict_batch(img)
    dflt = Predictor(model, compute_dtype=torch.float32, device="cpu",
                     input_scale=1.0, channel_flip=False,
                     **kw).predict_batch(img)
    for a, b in zip(base, dflt):
        assert torch.equal(a, b)
    pixels = np.round(img * 255.0)
    opts = dict(input_scale=1 / 255.0, channel_flip=True, **kw)
    got = Predictor(model, compute_dtype=torch.float32, device="cpu",
                    **opts).predict_image(pixels)
    ref = JaxPredictor(jm, params, compute_dtype=jnp.float32,
                       **opts).predict_image(pixels)
    assert len(ref[1]) > 0
    assert catalog_mismatch(ref, got) is None
