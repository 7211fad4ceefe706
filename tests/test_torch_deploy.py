"""Export and serve (caesar_yolo_tpu_torch/deploy.py, cli/export.py,
cli/serve.py) on the CPU: the twins of tests/test_deploy.py, the
refusals, the nine ops' fakes, and the live path kept off the ops
(tests/test_torch_deploy_jax.py holds the artifact to the JAX package's
and loads it without the model code).

Tolerances: an artifact against the live TileEngine within the JAX test's
own atol of 1e-5 (2e-4 for yolo11 with the chan3 chain, as the JAX test).
"""

import io
import json
import os
import threading
import urllib.error
import urllib.request
from collections import Counter

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from caesar_yolo_tpu_torch import deploy
from caesar_yolo_tpu_torch.deploy import (
    KERNEL_OPS,
    build_serving_step,
    export_detector,
    load_detector,
)
from caesar_yolo_tpu_torch.models.yolo import build_model, init_weights
from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
from caesar_yolo_tpu_torch.parallel.engine import TileEngine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
README = dict(zscale_stretch=True, normalize_minmax=True)
NAMES = ("boxes", "scores", "cls", "valid", "tile_ok", "n_dropped")
F32 = dict(compute_dtype=torch.float32, platforms="cpu")
# the live engine's settings of the small twins (JAX's test_deploy.py)
SMALL = dict(img_size=64, score_thr=0.01, max_det=20)


def _tiles(rng, b=2, h=64, w=64):
    t = rng.random((b, h, w, 1), dtype=np.float32)
    if b > 1:
        t[1, :8, :8] = 0.0  # masked corner, still valid
    return t


def _v8n():
    return init_weights(build_model("yolov8n", num_classes=5), seed=0)


def _assert_close(ref, got, atol):
    assert len(ref) == len(got) == 6
    for name, r, g in zip(NAMES, ref, got):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else g
        assert np.asarray(r).dtype == g.dtype, name
        np.testing.assert_allclose(np.asarray(r, np.float32),
                                   np.asarray(g, np.float32), atol=atol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def readme_blob():
    """yolov8n (seeded) at 64 px with the README chain, batch 2, f32, on
    the CPU: the artifact several tests share."""
    return export_detector(_v8n(), preprocessor=build_preprocessor(**README),
                           tile_shape=(64, 64, 1), batch=2, **SMALL, **F32)


def test_export_roundtrip_matches_engine(readme_blob):
    tiles = _tiles(np.random.default_rng(42))
    ref = TileEngine(_v8n(), preprocessor=build_preprocessor(**README),
                     device="cpu", compute_dtype=torch.float32,
                     **SMALL).process(tiles)
    assert isinstance(readme_blob, bytes) and len(readme_blob) > 0
    det = load_detector(readme_blob)
    assert det.input_shape == (2, 64, 64, 1) and det.device.type == "cpu"
    _assert_close(ref, det(tiles), atol=1e-5)


def test_serving_step_degenerate_tile():
    """All-zero tiles flag tile_ok=False through the serving step."""
    step = build_serving_step(_v8n(), preprocessor=build_preprocessor(
        **README), img_size=64, score_thr=0.01, device="cpu",
        compute_dtype=torch.float32)
    tiles = _tiles(np.random.default_rng(42))
    tiles[0] = 0.0
    with torch.no_grad():
        out = step(torch.from_numpy(tiles))
    assert out[4].tolist() == [False, True]
    assert not out[3][0].any()


def test_export_blob_is_standalone(readme_blob, tmp_path):
    """The artifact reloads from disk bytes alone (file -> call)."""
    p = tmp_path / "det.cyx"
    p.write_bytes(readme_blob)
    out = load_detector(p.read_bytes())(_tiles(np.random.default_rng(42)))
    assert out[0].shape == (2, 20, 4)
    assert [t.dtype for t in out] == [torch.float32, torch.float32,
                                      torch.int32, torch.bool, torch.bool,
                                      torch.int32]


def test_export_cli(tmp_path, caplog):
    from caesar_yolo_tpu_torch.cli.export import main
    from caesar_yolo_tpu_torch.models.convert import save_params
    w = tmp_path / "w.npz"
    save_params(_v8n(), str(w), meta={"model": "yolov8n", "num_classes": 5})
    out = tmp_path / "det.cyx"
    rc = main([f"--weights={w}", f"--out={out}", "--batch=1",
               "--tile_xsize=32", "--tile_ysize=32", "--imgsize=32",
               "--scoreThr=0.01", "--max_det=5", "--platforms=cpu",
               "--preprocessing", "--zscale_stretch", "--normalize_minmax"])
    assert rc == 0 and out.exists()
    det = load_detector(out.read_bytes())
    tiles = _tiles(np.random.default_rng(42), b=1, h=32, w=32)
    res = det(tiles)
    assert res[0].shape == (1, 5, 4)
    # the CLI's artifact is the library's on the same flags (bf16 default)
    ref = TileEngine(_v8n(), preprocessor=build_preprocessor(**README),
                     device="cpu", img_size=32, score_thr=0.01,
                     max_det=5).process(tiles)
    _assert_close(ref, res, atol=1e-5)


def test_export_quantized_detector(tmp_path):
    """int8 PTQ exports and serves through the same artifact path, equal
    to the live int8 engine; the CLI exports it from --int8 with a
    calibration image."""
    from caesar_yolo_tpu_torch.cli.export import main
    from caesar_yolo_tpu_torch.models.convert import save_params
    from caesar_yolo_tpu_torch.models.quant import (
        calibration_inputs_from_tiles,
        quantize_model,
    )
    from caesar_yolo_tpu_torch.utils.fits import write_fits
    pipe = build_preprocessor(**README)
    tiles = _tiles(np.random.default_rng(42), b=1, h=32, w=32)
    calib = calibration_inputs_from_tiles(tiles, preprocessor=pipe,
                                          img_size=32, device="cpu")
    qmodel = quantize_model(_v8n(), calib)
    blob = export_detector(qmodel, preprocessor=pipe, tile_shape=(32, 32, 1),
                           batch=1, img_size=32, score_thr=0.01, max_det=5,
                           **F32)
    out = load_detector(blob)(tiles)
    assert out[0].shape == (1, 5, 4)
    assert torch.isfinite(out[0]).all()
    ref = TileEngine(qmodel, preprocessor=pipe, device="cpu",
                     compute_dtype=torch.float32, img_size=32,
                     score_thr=0.01, max_det=5).process(tiles)
    _assert_close(ref, out, atol=1e-5)

    w, img, art = (tmp_path / n for n in ("w.npz", "c.fits", "q.cyx"))
    save_params(_v8n(), str(w), meta={"model": "yolov8n", "num_classes": 5})
    write_fits(tiles[0, :, :, 0], str(img))
    flags = [f"--weights={w}", f"--out={art}", "--batch=1", "--tile_xsize=32",
             "--tile_ysize=32", "--imgsize=32", "--platforms=cpu",
             "--preprocessing", "--zscale_stretch", "--normalize_minmax",
             "--int8"]
    assert main(flags) == 1 and not art.exists()     # no calibration image
    assert main([*flags, f"--calib_image={img}"]) == 0
    assert load_detector(art.read_bytes())(tiles)[0].shape == (1, 300, 4)


def test_http_serving_daemon(readme_blob, tmp_path):
    """cli.serve: export -> serve over HTTP -> the in-process artifact's
    detections (raw-bytes and .npy requests, health and error paths)."""
    from caesar_yolo_tpu_torch.cli.serve import build_server
    tiles = _tiles(np.random.default_rng(42))
    blob = readme_blob
    art = tmp_path / "det.cyx"
    art.write_bytes(blob)
    server = build_server(str(art), "127.0.0.1", 0)   # ephemeral port
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{port}"
        health = json.load(urllib.request.urlopen(f"{base}/healthz",
                                                  timeout=60))
        assert health == {"status": "ok", "input_shape": [2, 64, 64, 1],
                          "dtype": "float32"}
        req = urllib.request.Request(f"{base}/detect",
                                     data=tiles.astype("<f4").tobytes())
        resp = json.load(urllib.request.urlopen(req, timeout=60))
        assert len(resp["detections"]) == 2
        assert resp["tile_ok"] == [True, True]
        buf = io.BytesIO()
        np.save(buf, tiles)
        req2 = urllib.request.Request(f"{base}/detect", data=buf.getvalue())
        assert json.load(urllib.request.urlopen(req2, timeout=60)) == resp
        ref = load_detector(blob)(tiles)
        for i in range(2):
            v = ref[3][i].numpy()
            got = np.asarray(resp["detections"][i]["boxes"],
                             np.float32).reshape(-1, 4)
            np.testing.assert_allclose(got, ref[0][i].numpy()[v], atol=1e-4)
            assert resp["detections"][i]["class_ids"] == \
                ref[2][i].numpy()[v].tolist()
        for bad in (b"123", _npy(tiles[:1])):      # size, then shape
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(urllib.request.Request(
                    f"{base}/detect", data=bad), timeout=60)
            assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()


def _npy(a):
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def test_export_with_attention_and_native_batch_stages():
    """yolo11n at 128 px (C2PSA attention at N = 16, K2's op) with the
    chan3 chain (K5's and K6's ops): the artifact holds the kernels' ops
    and matches the live engine."""
    model = init_weights(build_model("yolo11n", num_classes=2), seed=0)
    pipe = build_preprocessor(chan3_preproc=True, normalize_minmax=True)
    tiles = _tiles(np.random.default_rng(42), b=2, h=128, w=128)
    kw = dict(img_size=128, score_thr=0.01, max_det=20)
    ref = TileEngine(model, preprocessor=pipe, device="cpu",
                     compute_dtype=torch.float32, **kw).process(tiles)
    blob = export_detector(model, preprocessor=pipe,
                           tile_shape=tiles.shape[1:], batch=2, **kw, **F32)
    det = load_detector(blob)
    ops = Counter(str(n.target).split(".")[1] for n in det.program.graph.nodes
                  if str(n.target).startswith("caesar_yolo."))
    assert ops == {"clip_stats": 2, "equalize_hist": 1, "attention": 1,
                   "upsample2x": 2, "nms_suppress": 1}, ops
    _assert_close(ref, det(tiles), atol=2e-4)


def test_refusals(readme_blob):
    """A wrong input shape, an export for two platforms, and a CUDA
    artifact's load where there is no CUDA are refused."""
    det = load_detector(readme_blob)
    with pytest.raises(ValueError, match="takes"):
        det(np.zeros((3, 64, 64, 1), np.float32))
    with pytest.raises(ValueError, match="one device"):
        export_detector(_v8n(), tile_shape=(32, 32, 1), batch=1,
                        img_size=32, platforms=("cuda", "cpu"))
    # the CUDA artifact's record, written by hand into the CPU artifact
    meta = deploy.artifact_meta(readme_blob)
    assert meta["device"] == "cpu" and meta["input_shape"] == [2, 64, 64, 1]
    cuda_blob = _with_meta(readme_blob, {**meta, "device": "cuda"})
    assert deploy.artifact_meta(cuda_blob)["device"] == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA"):
            load_detector(cuda_blob)


def _with_meta(blob, meta):
    import zipfile
    src = zipfile.ZipFile(io.BytesIO(blob))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as dst:
        for info in src.infolist():
            data = src.read(info.filename)
            if info.filename.endswith(f"extra/{deploy.META_FILE}"):
                data = json.dumps(meta).encode()
            dst.writestr(info, data)
    return buf.getvalue()


def _op_cases():
    """CPU arguments of each op at a small size."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)   # noqa: E731
    boxes = torch.rand(2, 16, 4, generator=g) * 20
    boxes[..., 2:] += boxes[..., :2]
    planes = r(3, 24, 20)
    x = r(2, 8, 6, 6)
    wq = torch.randint(-127, 128, (4, 8, 3, 3), generator=g,
                       dtype=torch.int8)
    return {
        "nms_suppress": (boxes.transpose(1, 2).contiguous(),
                         torch.rand(2, 16, generator=g) > 0.3, 0.5),
        "attention": (r(1, 2, 16, 8), r(1, 2, 16, 8), r(1, 2, 16, 4), 0.35),
        "zscale_minmax": (planes, torch.tensor([[-1.0, 1.0]] * 3), 0.0, 1.0),
        "upsample2x": (x,),
        "clip_stats": (planes, 3.0, 3.0, 5, None),
        "equalize_hist": (planes,),
        "equalize_adapthist": (torch.rand(2, 32, 32, generator=g), 0.03, 8),
        "qconv": (x, wq, torch.rand(4, generator=g) * 1e-2,
                  torch.tensor([0.03]), r(4), 1, 1, True, None),
        "conv_epilogue": (x, torch.rand(8, generator=g) + 0.5, r(8), True),
    }


@pytest.mark.parametrize("name", KERNEL_OPS)
def test_op_fake_matches_the_cpu_result(name):
    """Each op's fake gives its CPU result's shapes, dtypes and strides,
    and the op is the wrapper's dispatch (its CPU result is the plain
    version's); torch.library.opcheck's schema and fake-tensor checks
    pass."""
    op = getattr(torch.ops.caesar_yolo, name)
    args = _op_cases()[name]
    real = op(*args)
    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
        fake = op(*fargs)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(t.shape, t.dtype, t.stride()) for t in fake] == \
        [(t.shape, t.dtype, t.stride()) for t in real]
    torch.library.opcheck(op, args, test_utils=("test_schema",
                                                 "test_faketensor"))


def test_live_path_does_not_call_the_ops():
    """A live CPU forward of the tile step dispatches no caesar_yolo op
    (the wrappers launch directly outside export); a direct call of an op
    under the same mode is seen."""

    class Namespaces(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen[func.namespace] += 1
            return func(*args, **(kwargs or {}))

    model = init_weights(build_model("yolo11n", num_classes=2), seed=0)
    engine = TileEngine(model, preprocessor=build_preprocessor(
        chan3_preproc=True, normalize_minmax=True), device="cpu",
        compute_dtype=torch.float32, img_size=128, score_thr=0.01)
    tiles = _tiles(np.random.default_rng(42), b=1, h=128, w=128)
    with Namespaces() as mode:
        engine.process(tiles)
    assert mode.seen["aten"] > 100 and not mode.seen["caesar_yolo"]
    with Namespaces() as mode:
        torch.ops.caesar_yolo.upsample2x(torch.zeros(1, 2, 3, 3))
    assert mode.seen["caesar_yolo"] == 1
