"""The cell v12l-survey and what it adds to the benchmark, on the CPU at
a small size (yolo12n, a 1024 px field of 16 tiles in batches of 4): the
reference's YOLO12 is the program's, a sound traced run is correct and
reports the new metrics, the fp8 control and a planted fault are not
correct, the new readers match their entries, and the reference's YOLO12
leaves reference.model as it was.  On the card (`cuda`):
the fp8 control fails the check at the cell's own size."""

import io
import json
import os
from types import SimpleNamespace

import pytest
import torch

from torch.utils.flop_counter import FlopCounterMode

import reference.model
import reference.yolo12 as y12
import run as bench
from counts import attn
from harness.core import ROOT, Cell, metric_reader
from reference.model import leaves, load_npz
from reference.weights import draw, save_npz

NEW = {"attn_roofline.survey": ["v11l-survey", "v12l-survey"],
       "area_attn_fused_share.survey": ["v12l-survey"]}


def small_cell(name="v12l-survey"):
    cell = Cell(name)
    cell.config = dict(cell.config, model="yolo12n")
    flags = [f if not f.startswith("--batch_size=") else "--batch_size=4"
             for f in cell.params["flags"]]
    cell.params = dict(cell.params, flags=flags, field=dict(
        cell.params["field"], field_px=1024, n_sources=64))
    return cell


def run_cell(cell, seed, trace=0, variant=""):
    out = io.StringIO()
    argv = ["--workload", cell.name, "--seed", str(seed), "--seconds", "0",
            "--trace", str(trace)] + (["--variant", variant] if variant
                                      else [])
    assert bench.run(argv, device="cpu", cell=cell, out=out) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_the_readers_match_their_entries():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        rows = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name, cells in NEW.items():
        m, mod = rows[name], metric_reader(name)
        assert (mod.LAYER, mod.SOURCE, mod.MOVES, mod.UNIT) == (
            m["layer"], m["source"], m["moves"], m["unit"])
        assert m["workloads"] == cells


def test_the_reference_model_module_is_left_as_it_was():
    """YOLO12 is a class of its own: reference.model's table still knows
    v8 and v11 alone, whatever was imported before."""
    assert reference.model.parse_name("yolo11l") == ("v11", "l")
    with pytest.raises(ValueError, match="yolo12l"):
        reference.model.YOLO("yolo12l")
    assert "v12" not in reference.model.SCALES
    assert type(y12.build("yolo11n")) is reference.model.YOLO
    assert type(y12.build("yolo12n")) is y12.YOLO12


@pytest.mark.parametrize("name", ["yolo12n", "yolo12l"])
def test_the_reference_equals_the_program_through_the_npz(name, tmp_path):
    from caesar_yolo_tpu_torch.models.convert import load_model
    cfg = Cell("v12l-survey").config
    model = y12.YOLO12(name, 5)
    draw(model, 3, cfg["init"], "cpu")
    y12.draw_layer_scale(model, 3, cfg["init"]["layer_scale"], "cpu")
    gammas = [t for k, t in leaves(model) if k.endswith("a2c2f_1/gamma")]
    assert (len(gammas) == 1) == (name == "yolo12l")
    assert all(0.5 <= float(g.min()) and float(g.max()) <= 1.5
               for g in gammas)
    path = save_npz(model, str(tmp_path / "w.npz"),
                    {"model": name, "num_classes": 5})
    port = load_model(path)[0].eval()
    assert torch.equal(load_npz(y12.YOLO12(name, 5), path).a2c2f_2.cv1.w,
                       model.a2c2f_2.cv1.w)
    x = torch.rand(2, 3, 128, 128, generator=torch.Generator()
                   .manual_seed(0))
    with torch.no_grad():
        for (rb, rc), (gb, gc) in zip(model.eval()(x), port(x)):
            assert float((rb - gb).abs().max()) <= 1e-4 * float(
                rb.abs().max())
            assert float((rc - gc).abs().max()) <= 1e-4 * float(
                rc.abs().max())


def test_counts_of_yolo12l():
    """88.9 GFLOPs of convolutions at 640 px (the published count) and
    6.55 of attention products; 16 attention calls a forward, 8 over
    P4's four strips of 400 positions and 8 over P5's 400."""
    model = y12.YOLO12("yolo12l", 80).to("meta").eval()
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(torch.zeros(1, 3, 640, 640, device="meta"))
    assert 95.0e9 < fc.get_total_flops() < 95.9e9
    calls = attn.attention_calls("yolo12l", 5, 32, 640)
    assert calls == ((128, 8, 400, 32, 32),) * 8 + ((32, 8, 400, 32, 32),) * 8
    f, b = attn.attention_work("yolo12l", 5, 32, 640)
    assert f == 8 * 2 * (128 + 32) * 8 * 400 ** 2 * 64
    assert b == 8 * 2 * (128 + 32) * 8 * 400 * 128
    # yolo11l's two C2PSA calls: kd 32, hd 64
    assert attn.attention_calls("yolo11l", 5, 32, 640) == (
        (32, 4, 400, 32, 64),) * 2


def test_a_sound_traced_run_is_correct_and_reports_the_new_metrics():
    result = run_cell(small_cell(), 2**31 + 17, trace=1)
    assert result["correct"], result["checks"]
    m = result["metrics"]
    # on the CPU every area-attention call is plain, and no K2 runs
    assert m["area_attn_fused_share.survey"]["value"] == 0.0
    assert "attn_roofline.survey" not in m
    assert set(m) <= {x["name"] for x in small_cell().per_layer()}
    for name in ("cli_setup_share.survey", "read_share.survey",
                 "post_share.survey"):
        assert 0.0 < m[name]["value"] < 100.0, name


def test_a_sound_run_reports_the_end_to_end_metrics():
    result = run_cell(small_cell(), 2**31 + 5)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"survey_tiles_per_s", "setup_s"}


@pytest.mark.parametrize("variant", ["fp8", "fault:moved_boxes"])
def test_the_control_and_a_fault_are_not_correct(variant):
    result = run_cell(small_cell(), 2**31 + 17, variant=variant)
    assert not result["correct"]
    miss = result["checks"]["catalog_miss"]
    assert miss["value"] > miss["limit"]


def test_a_program_without_yolo12_fails_at_once(monkeypatch):
    from caesar_yolo_tpu_torch.models import yolo

    def refuse(name, *a, **k):
        raise ValueError(f"cannot parse model name {name!r}")
    monkeypatch.setattr(yolo, "build_model", refuse)
    argv = ["--workload", "v12l-survey", "--seed", "1", "--seconds", "0"]
    with pytest.raises(ValueError, match="yolo12n"):
        bench.run(argv, device="cpu", cell=small_cell())


def test_fused_share_and_rank_spread_readers():
    ctx = SimpleNamespace(units=[
        {"rc": 0, "phase": {"model.area_attn_fused": 48.0,
                            "model.area_attn_plain": 16.0},
         "ranks": [{"detect": 2.0}, {"detect": 3.0}]},
        {"rc": 0, "phase": {"model.area_attn_fused": 64.0},
         "ranks": [{"detect": 2.0}, {"detect": 1.0}]},
        {"rc": 1, "phase": {"model.area_attn_plain": 99.0},
         "ranks": [{"detect": 9.0}, {"detect": 0.0}]}])
    assert metric_reader("area_attn_fused_share.survey").read(ctx) == \
        pytest.approx(100.0 * 112 / 128)
    assert metric_reader("rank_spread.survey").read(ctx) == \
        pytest.approx(100.0 * 4.0 / 4.0)
    empty = SimpleNamespace(units=[{"rc": 0, "phase": {"detect": 1.0}}])
    assert metric_reader("area_attn_fused_share.survey").read(empty) is None
    assert metric_reader("rank_spread.survey").read(empty) is None


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 202, 2**31 + 303])
def test_the_fp8_control_fails_at_the_cells_size(seed, card):
    out = io.StringIO()
    argv = ["--workload", "v12l-survey", "--seed", str(seed), "--seconds",
            "0", "--variant", "fp8"]
    assert bench.run(argv, device=card, out=out) == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert not result["correct"], result["checks"]
