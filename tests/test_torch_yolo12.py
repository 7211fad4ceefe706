"""YOLO12 in the port against its plain twin (tests/ultra_ref.py), on the
CPU: the raw head maps in f32 and bf16, area attention alone, negative
controls that the comparison must see, the parameter count, the
area-attention counters, a training step, and the conversion of an
ultralytics-named state dict through `cli.run --weights`.

Both sides carry the same seeded random weights, loaded into the port by
name through the ultralytics converter (BatchNorm statistics random, the
A2C2f layer scale gamma ~ U(0.5, 1.5): at ultralytics' 0.01 the attention
stages would hardly reach the outputs)."""

import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from caesar_yolo_tpu_torch.detect.predictor import prepare_model
from caesar_yolo_tpu_torch.models import layers
from caesar_yolo_tpu_torch.models.convert import (convert_checkpoint,
                                                  convert_state_dict)
from caesar_yolo_tpu_torch.models.layers import AAttn, A2C2f
from caesar_yolo_tpu_torch.models.yolo import build_model
from ultra_ref import TAAttn, build_torch_twin

torch.set_num_threads(1)

# f32: only the order of the sums differs (BatchNorm as y * scale + shift
# against (y - mean) / sqrt(var + eps) * gamma + beta, and the attention's
# products), so each raw map agrees to 1e-4 of its largest magnitude
REL_ATOL = 1e-4
# ROADMAP's bf16 rule, the part that holds raw maps (tests/
# test_torch_models.py:test_bf16_head_keeps_the_reference_biases, which
# holds the yolo11/v8 bf16 head to the JAX package's): each level's class
# logits, averaged over every anchor and image, within 4e-3 of the
# reference's; rounding noise cancels in the mean, a shifted bias or a
# dropped stage does not
LOGIT_MEAN_TOL = 4e-3
# (model, image size, batch): yolo12n, and the scale-l topology (area
# attention over 4 strips at P4, layer-scale residuals)
CASES = [("yolo12n", 64, 2), ("yolo12l", 128, 2)]


def state_of(twin):
    return {k: v.detach().numpy() for k, v in twin.state_dict().items()}


def pair(name, seed=0):
    """(twin, port) with the twin's weights loaded into the port by name."""
    twin = build_torch_twin(name, nc=5, seed=seed)
    port = build_model(name, num_classes=5)
    port.load_state_dict(convert_state_dict(state_of(twin), port))
    return twin, port.eval()


def images(size, batch, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(batch, 3, size, size, generator=g)


def worst_rel_error(got, ref):
    """The largest of max|got - ref| / max|ref| over the raw maps."""
    return max(float((g - r).abs().max() / r.abs().max())
               for gl, rl in zip(got, ref) for g, r in zip(gl, rl))


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    name, size, batch = request.param
    twin, port = pair(name)
    x = images(size, batch)
    with torch.no_grad():
        ref = twin(x)
    return name, twin, port, x, ref


def test_raw_maps_match_the_twin_in_f32(case):
    _, _, port, x, ref = case
    with torch.no_grad():
        got = port(x)
    assert worst_rel_error(got, ref) <= REL_ATOL


def test_bf16_raw_maps_keep_the_class_logit_means(case):
    """The bf16 inference model (BN folded, weights cast) against the f32
    twin by ROADMAP's bf16 rule for raw maps (LOGIT_MEAN_TOL)."""
    _, _, port, x, ref = case
    model = prepare_model(port, dtype=torch.bfloat16,
                          device=torch.device("cpu"))
    with torch.no_grad():
        got = model(x.bfloat16())
    for (_, gc), (_, rc) in zip(got, ref):
        assert gc.dtype == torch.bfloat16
        gap = float((gc.float() - rc).mean())
        assert abs(gap) <= LOGIT_MEAN_TOL, gap


@pytest.mark.parametrize("area", [1, 4])
def test_area_attention_alone_matches_the_twin(area):
    torch.manual_seed(area)
    twin = TAAttn(64, 2, area).eval()
    for m in twin.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.5, 0.5)
            m.running_var.uniform_(0.5, 1.5)
    port = AAttn(64, 2, area)
    state = {k.replace(".conv.weight", ".w").replace(".bn.weight", ".bn.gamma")
             .replace(".bn.bias", ".bn.beta")
             .replace(".bn.running_mean", ".bn.mean")
             .replace(".bn.running_var", ".bn.var"): v
             for k, v in twin.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    port.load_state_dict(state)
    x = torch.rand(2, 64, 8, 8, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref, got = twin(x), port.eval()(x)
    assert float((got - ref).abs().max()) <= REL_ATOL * float(
        ref.abs().max())


def test_area_that_does_not_divide_the_positions_raises():
    with pytest.raises(ValueError, match="area 4"):
        AAttn(32, 1, 4).eval()(torch.rand(1, 32, 3, 3))


def _no_strips(model):
    for m in model.modules():
        if isinstance(m, AAttn):
            m.area = 1


def _pe_3x3(model):
    for m in model.modules():
        if isinstance(m, AAttn):
            pe = m.pe
            pe.w = torch.nn.Parameter(pe.w.data[:, :, 2:5, 2:5].clone())
            pe.k, pe.pad = 3, 1


def _gamma_dropped(model):
    for m in model.modules():
        if isinstance(m, A2C2f) and m.gamma is not None:
            m.gamma.data.fill_(1.0)


@pytest.mark.parametrize("control", [_no_strips, _pe_3x3, _gamma_dropped],
                         ids=["no_strip_split", "pe_3x3", "gamma_dropped"])
def test_negative_controls_fail_the_f32_comparison(control):
    """What the comparison must see, at the scale-l topology: attention
    over the whole map instead of 4 strips, a 3x3 positional conv, and
    the layer scale taken as 1.  Each fails REL_ATOL, by a factor of 4 at
    least (on this CPU the sound port reads 7.6e-7 of max|ref|, the
    controls 8.7e-4, 7.0e-3 and 8.9e-3)."""
    twin, port = pair("yolo12l")
    x = images(128, 2)
    with torch.no_grad():
        ref = twin(x)
        assert worst_rel_error(port(x), ref) <= REL_ATOL
        control(port)
        assert worst_rel_error(port(x), ref) > 4 * REL_ATOL


def test_parameter_count_at_80_classes_is_the_published_one():
    """ultralytics counts model.parameters() (26,450,768 here and its
    own 16 DFL weights): the published 26.4 M within 1%."""
    n = sum(p.numel() for p in build_model("yolo12l", 80).parameters())
    assert abs(n - 26.4e6) <= 0.01 * 26.4e6
    assert n == sum(p.numel() for p in build_torch_twin(
        "yolo12l", 80).parameters())


def test_counters_count_every_call_plain_on_the_cpu():
    """16 area-attention calls a yolo12l forward (8 ABlocks at P4, 8 at
    P5); on the CPU every one takes the plain path, even where the
    reference's gate would take the kernel (P4's strips of 16 positions
    at 128 px)."""
    _, port = pair("yolo12l")
    before = layers.area_attn_counts()
    with torch.no_grad():
        port(images(128, 1))
    after = layers.area_attn_counts()
    assert after[layers.AREA_ATTN_PLAIN] - before[layers.AREA_ATTN_PLAIN] \
        == 16
    assert after[layers.AREA_ATTN_FUSED] == before[layers.AREA_ATTN_FUSED]
    assert (layers.area_attention, "fused") in layers.cuda_build.COUNTERS


@pytest.mark.parametrize("name", ["yolo12n", "yolo12l"])
def test_one_training_step_reaches_every_parameter(name):
    """One Trainer.train_step on the CPU at 64 px: a finite loss, and a
    finite gradient on every parameter, the layer scales included (scale
    l)."""
    from caesar_yolo_tpu_torch.train.trainer import Trainer, TrainConfig
    _, port = pair(name)
    trainer = Trainer(port, TrainConfig(epochs=1, batch_size=2, img_size=64,
                                        compute_dtype="float32"),
                      steps_per_epoch=2, device="cpu")
    rng = np.random.default_rng(0)
    imgs = rng.random((2, 64, 64, 3), dtype=np.float32)
    boxes = np.array([[[4, 6, 30, 28], [20, 20, 50, 60]]] * 2, np.float32)
    labels = np.array([[1, 3]] * 2, np.int32)
    mask = np.ones((2, 2), bool)
    loss, _ = trainer.train_step(imgs, labels, boxes, mask)
    assert torch.isfinite(loss)
    params = dict(trainer.model.named_parameters())
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in params.values())
    gammas = [k for k in params if k.endswith(".gamma")
              and ".bn." not in k]
    assert len(gammas) == (2 if name == "yolo12l" else 0)
    assert all(params[k].grad.abs().sum() > 0 for k in gammas)


def test_ultralytics_state_dict_converts_and_runs_through_cli(tmp_path):
    """The twin's state dict under ultralytics' names (`model.6.m.0.0.attn.
    qkv.conv.weight`, `model.6.gamma`, ...) saved as a checkpoint,
    converted to the npz format, and read back by `cli.run --weights` on a
    small field: the converted model gives the twin's raw maps, the CLI's
    model (prepared from the npz on the engine's device) is bit-equal to
    prepare_model's copy of it, and its run reports the area-attention
    calls (all plain on the CPU)."""
    from caesar_yolo_tpu_torch.cli import run as cli_run
    from caesar_yolo_tpu_torch.utils.synth import write_mosaic_fits
    twin = build_torch_twin("yolo12l", nc=5, seed=2)
    sd = twin.state_dict()
    assert "model.6.m.0.0.attn.qkv.conv.weight" in sd and "model.6.gamma" \
        in sd
    pt, npz = str(tmp_path / "yolo12l_twin.pt"), str(tmp_path / "w.npz")
    torch.save(sd, pt)
    model, meta = convert_checkpoint(pt, npz, model_name="yolo12l")
    assert meta == {"model": "yolo12l", "num_classes": 5}
    field = str(tmp_path / "field.fits")
    write_mosaic_fits(field, 160, 160, n_sources=6, seed=1)
    os.chdir(tmp_path)
    rc, sf = cli_run.run([
        f"--image={field}", f"--weights={npz}", "--devices=cpu",
        "--imgsize=64", "--preprocessing", "--normalize_minmax",
        "--split_img_in_tiles", "--tile_xsize=96", "--tile_ysize=96",
        "--tile_xstep=0.75", "--tile_ystep=0.75", "--batch_size=4",
        "--detect_outfile_json=c.json", "--detect_outfile=c.reg"])
    assert rc == 0
    x = images(64, 2, seed=5)
    with torch.no_grad():
        ref = twin(x)
        assert worst_rel_error(model.eval()(x), ref) <= REL_ATOL
    copied = prepare_model(model, dtype=sf.model.compute_dtype,
                           device=torch.device("cpu"))
    assert cs.prepared_mismatch(torch, sf.model, copied) == []
    phase = sf.report.phase_times
    forwards = phase["engine.eager_batches"]
    assert phase[layers.AREA_ATTN_PLAIN] == 16 * forwards > 0
    assert phase[layers.AREA_ATTN_FUSED] == 0
