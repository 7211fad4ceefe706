"""npz weights to the engine's model in one pass (models/convert.py:
read_npz, build_prepared), cli.run's route, on the CPU.

For yolo11l, yolov8l and yolo12l at 5 classes, with weights drawn from a
seed and written as the benchmark writes them (chip_smoke.save_hwio_npz:
HWIO, 1x1 kernels column-major): the model built straight from the npz is
bit-equal to prepare_model's copy of load_model's in every parameter
(name, dtype, shape, strides), and a byte flipped in one member raises a
CRC error as np.load does.  On the trained yolov8n fixture: cli.run's
engine runs the direct model itself on the npz route alone (not for a
compressed npz, --int8 or a .pt checkpoint), an engine made on a
prepared model runs it and detects as the copying engine does, and its
update_params leaves the caller's model unchanged.  prepare_model takes
a model that is already its inference model as it is, and copies any
other.
"""

import copy
import json
import os
import zipfile

import numpy as np
import pytest
import torch

import chip_smoke as cs
from caesar_yolo_tpu_torch.cli import run as cli_run
from caesar_yolo_tpu_torch.detect.predictor import prepare_model
from caesar_yolo_tpu_torch.models import quant
from caesar_yolo_tpu_torch.models.convert import (build_prepared, load_model,
                                                  read_npz)
from caesar_yolo_tpu_torch.models.layers import cast_weights, fuse_tree
from caesar_yolo_tpu_torch.parallel.engine import TileEngine
from caesar_yolo_tpu_torch.utils.synth import write_mosaic_fits

torch.set_num_threads(2)

WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "yolov8n_synth96.npz")
CPU = torch.device("cpu")
FLAGS = ["--imgsize=96", "--devices=cpu", "--scoreThr=0.3",
         "--preprocessing", "--normalize_minmax", "--split_img_in_tiles",
         "--tile_xsize=96", "--tile_ysize=96", "--tile_xstep=0.75",
         "--tile_ystep=0.75", "--batch_size=4"]


@pytest.fixture(scope="module", params=cs.DIRECT_MODELS)
def npz(request, tmp_path_factory):
    name = request.param
    path = str(tmp_path_factory.mktemp("direct") / f"{name}.npz")
    cs.save_hwio_npz(cs.seeded_model(torch, name, 3), path,
                     {"model": name, "num_classes": 5})
    return name, path


def test_the_direct_model_is_bit_equal_to_prepare_models(npz):
    name, path = npz
    direct, copied = cs.direct_and_copied(torch, path, name, CPU)
    assert cs.prepared_mismatch(torch, direct, copied) == []
    # the kernels stored column-major (1x1) took the route too
    with zipfile.ZipFile(path) as z, z.open(f"{name_of_1x1(direct)}.npy") \
            as f:
        assert np.lib.format.read_magic(f) == (1, 0)
        assert np.lib.format.read_array_header_1_0(f)[1]


def name_of_1x1(model):
    """The npz key of the model's first 1x1 conv kernel."""
    return next(k.replace(".", "/") for k, p in model.named_parameters()
                if p.ndim == 4 and p.shape[2:] == (1, 1))


def member_bytes(path, key):
    """(offset, size) of member `key`'s bytes in the npz file."""
    with zipfile.ZipFile(path) as z:
        info = z.getinfo(f"{key}.npy")
    with open(path, "rb") as f:
        f.seek(info.header_offset + 26)
        n, extra = np.frombuffer(f.read(4), "<u2")
    return info.header_offset + 30 + int(n) + int(extra), info.file_size


@pytest.mark.parametrize("leaf", ["kernel", "bn"])
def test_a_flipped_byte_raises_a_crc_error(npz, leaf):
    """A byte flipped inside one member's array, of a large kernel (read
    on the pool) or a small BatchNorm vector (read inline): read_npz
    raises zipfile.BadZipFile naming the CRC, as np.load does."""
    name, path = npz
    with np.load(path) as z:
        key = (max(z.files, key=lambda k: z[k].size) if leaf == "kernel"
               else next(k for k in z.files if k.endswith("/bn/var")))
    start, size = member_bytes(path, key)
    at = start + size - 5
    with open(path, "r+b") as f:
        f.seek(at)
        byte = f.read(1)
        f.seek(at)
        f.write(bytes([byte[0] ^ 0x10]))
    try:
        with pytest.raises(zipfile.BadZipFile, match="CRC"):
            read_npz(path)
        with pytest.raises(zipfile.BadZipFile, match="CRC"), \
                np.load(path) as z:
            z[key]
    finally:
        with open(path, "r+b") as f:
            f.seek(at)
            f.write(byte)
    assert read_npz(path) is not None


@pytest.fixture(scope="module")
def mosaic(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("field") / "field.fits")
    write_mosaic_fits(path, 208, 208, n_sources=12, seed=3)
    return path


@pytest.mark.parametrize("route", ["npz", "compressed", "int8", "pt"])
def test_cli_run_takes_the_direct_route_on_npz_alone(mosaic, tmp_path,
                                                     route):
    """A tiled cli.run on npz weights builds its engine on the direct
    route: the route's child spans, and the engine runs the SFinder's
    model itself, with no copy; a compressed npz, --int8 and a .pt
    checkpoint take the copy route, with neither."""
    weights, extra = WEIGHTS, []
    if route == "compressed":
        weights = str(tmp_path / "compressed.npz")
        with np.load(WEIGHTS) as z:
            np.savez_compressed(weights, **{k: z[k] for k in z.files})
        assert read_npz(weights) is None
    elif route == "int8":
        extra = ["--int8"]
    elif route == "pt":
        weights = str(tmp_path / "yolov8n_synth96.pt")
        cs.save_ultralytics_pt(torch, weights,
                               cs.ultralytics_state(load_model(WEIGHTS)[0]))
    out = tmp_path / "c.json"
    rc, sf = cli_run.run([f"--image={mosaic}", f"--weights={weights}",
                          *FLAGS, *extra, f"--detect_outfile_json={out}",
                          f"--detect_outfile={tmp_path}/c.reg",
                          f"--spool_path={tmp_path}/spool.jsonl"])
    assert rc == 0
    phase = sf.report.phase_times
    direct = route == "npz"
    assert (sf._engine.model is sf.model) == direct
    for child in cs.DIRECT_SPANS:
        assert (child in phase) == direct, child
    # a .pt checkpoint is converted to its model inside cli.load_weights
    assert {k for k in cs.SETUP_SPANS if phase.get(k, 0) > 0} == set(
        cs.SETUP_SPANS) - ({"cli.build"} if route == "pt" else set())
    assert json.loads(out.read_text())["sources"]


def _tiles():
    rng = np.random.default_rng(5)
    tiles = rng.normal(0.0, 0.1, (4, 96, 96, 1)).astype(np.float32)
    tiles[:, 30:40, 50:60] += 3.0
    return tiles


def test_an_engine_runs_a_prepared_model_and_update_params_copies():
    """TileEngine takes the direct model itself, no copy, and detects as
    an engine built on load_model's model; update_params on it copies,
    folds and casts the caller's model and leaves it unchanged."""
    prepared = build_prepared(read_npz(WEIGHTS), "yolov8n", 5,
                              dtype=torch.bfloat16, device=CPU)
    kw = dict(img_size=96, score_thr=0.05, device="cpu")
    engine = TileEngine(prepared, **kw)
    assert engine.model is prepared
    assert engine.compute_dtype == torch.bfloat16
    model = load_model(WEIGHTS)[0]
    copying = TileEngine(model, **kw)
    assert copying.model is not model
    tiles = _tiles()
    for a, b in zip(engine.process(tiles), copying.process(tiles)):
        np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.9)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    engine.update_params(model)
    assert engine.model is not model and engine.model is not prepared
    for k, v in model.state_dict().items():
        assert v.dtype == before[k].dtype and torch.equal(v, before[k]), k
    fresh = TileEngine(model, **kw)
    for a, b in zip(engine.process(tiles), fresh.process(tiles)):
        np.testing.assert_array_equal(a, b)


def test_weights_that_do_not_fit_the_model_raise(tmp_path):
    """The direct build is strict, as load_jax_params' load: weights of
    another architecture raise, naming what is missing."""
    with pytest.raises(RuntimeError, match="do not fit yolo11n"):
        build_prepared(read_npz(WEIGHTS), "yolo11n", 5,
                       dtype=torch.bfloat16, device=CPU)


def _stepwise(model, dtype, fold):
    """The inference copy of `model` on the CPU made step by step: f32,
    eval, BatchNorm folded where `fold`, conv weights cast to `dtype`."""
    ref = copy.deepcopy(model).float().eval()
    if fold:
        fuse_tree(ref)
    ref = cast_weights(ref, dtype)
    ref.compute_dtype = dtype
    return ref


@pytest.mark.parametrize("case", ["prepared", "other_dtype", "training",
                                  "int8"])
def test_prepare_model_copies_all_but_its_own_inference_model(case):
    """prepare_model's rule on the CPU.  A prepared model asked for at its
    own dtype and device, or with no dtype, is returned as it is.  Asked
    for another dtype it is copied, as the step-by-step copy, and stays as
    it was.  A training f32 model is copied in COMPUTE_DTYPE and left
    unchanged.  An int8 model's copy equals, bit for bit in its state and
    in its outputs on a fixed input, the step-by-step copy with no fold:
    its Convs have no BatchNorm left to fold."""
    x = torch.from_numpy(np.random.default_rng(9).random(
        (2, 3, 96, 96), dtype=np.float32))
    model = load_model(WEIGHTS)[0]
    if case == "prepared":
        prepared = build_prepared(read_npz(WEIGHTS), "yolov8n", 5,
                                  dtype=torch.bfloat16, device=CPU)
        assert prepare_model(prepared, dtype=torch.bfloat16,
                             device=CPU) is prepared
        assert prepare_model(prepared, device=CPU) is prepared
        return
    dtype, fold = torch.float32, True
    if case == "other_dtype":
        model = prepare_model(model, dtype=torch.bfloat16, device=CPU)
    elif case == "training":
        dtype = torch.bfloat16
    else:
        model = quant.quantize_model(model, [x])
        fold = False
    before = {k: v.clone() for k, v in model.state_dict().items()}
    was = model.compute_dtype
    got = prepare_model(model, dtype=None if case == "training" else dtype,
                        device=CPU)
    assert got is not model and got.compute_dtype == dtype
    assert model.compute_dtype == was
    for k, v in model.state_dict().items():
        assert v.dtype == before[k].dtype and torch.equal(v, before[k]), k
    ref = _stepwise(model, dtype, fold)
    assert cs.prepared_mismatch(torch, got, ref) == []
    with torch.no_grad():
        for a, b in zip(sum(got(x.to(dtype)), ()), sum(ref(x.to(dtype)), ())):
            assert torch.equal(a, b)
