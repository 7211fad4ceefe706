"""The survey cells' comparison: the plain reference agrees with the
program, the check passes a sound run and fails a broken one.

On the CPU at a small size (yolo11n / yolov8n, a 1024 px field of 16
tiles in batches of 4): the program's catalog in f32 equals the reference's; a run through
the harness is correct; with half of each batch's tiles left out, or every
box moved where the engine produces it, it is not.  On the card
(`cuda`): the control, the program's own int8 path, at the cell's own
size fails the check on three seeds.
"""

import io
import json

import numpy as np
import pytest
import torch

import run as bench
from harness.core import Cell
from reference import compare, survey
from reference.model import YOLO
from reference.weights import calibrate, draw, save_npz
from traffic import mosaic

CELLS = ("v11l-survey", "v8l-survey-bkg")
SMALL = {"yolo11l": "yolo11n", "yolov8l": "yolov8n"}


def small_cell(name):
    cell = Cell(name)
    cell.config = dict(cell.config, model=SMALL[cell.config["model"]])
    flags = [f if not f.startswith("--batch_size=") else "--batch_size=4"
             for f in cell.params["flags"]]
    cell.params = dict(cell.params, flags=flags, field=dict(
        cell.params["field"], field_px=1024, n_sources=64))
    return cell


def run_cell(cell, seed, device="cpu", variant=""):
    out = io.StringIO()
    argv = ["--workload", cell.name, "--seed", str(seed), "--seconds", "0",
            "--trace", "0"] + (["--variant", variant] if variant else [])
    assert bench.run(argv, device=device, cell=cell, out=out) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_the_program_in_f32(name, tmp_path, monkeypatch):
    from caesar_yolo_tpu_torch.cli.preproc_args import (
        build_preprocessor_from_args)
    from caesar_yolo_tpu_torch.cli.run import (config_from_args,
                                               load_model_from_args,
                                               parse_args)
    from caesar_yolo_tpu_torch.parallel.sfinder import SFinder
    cell = small_cell(name)
    p, cfg = cell.params, cell.config
    img = mosaic.make_field(np.random.default_rng(5), **p["field"])
    mosaic.write_fits(img, str(tmp_path / "f.fits"))
    field = np.nan_to_num(img, nan=0.0)
    a = survey.parse_flags(p["flags"])
    model = draw(YOLO(cfg["model"], 5), 7, cfg["init"], "cpu")
    planes = torch.stack([torch.from_numpy(field[y0:y1, x0:x1]) for
                          x0, x1, y0, y1 in survey.tile_grid(1024, 1024, a)
                          if x1 - x0 == y1 - y0 == 512][:8])
    calibrate(model, survey.letterbox(survey.preprocess(planes, a)[0],
                                      a.imgsize), cfg["init"], a.scoreThr)
    save_npz(model, str(tmp_path / "w.npz"),
             {"model": cfg["model"], "num_classes": 5})
    ref = survey.catalog(model, field, p["flags"], "cpu")
    monkeypatch.chdir(tmp_path)
    args = parse_args([f"--image={tmp_path / 'f.fits'}",
                       f"--weights={tmp_path / 'w.npz'}", *p["flags"]])
    sf = SFinder(load_model_from_args(args), config_from_args(args),
                 preprocessor=build_preprocessor_from_args(args),
                 engine_kwargs={"compute_dtype": torch.float32},
                 device="cpu")
    assert sf.run_tiled() == 0
    ours = sf.sources["sources"]
    assert len(ours) == len(ref) > 0

    def key(s):
        return (s["x1"], s["y1"], s["x2"], s["y2"], s["class_id"],
                bool(s["merged"]))
    assert sorted(map(key, ours)) == sorted(map(key, ref))
    by_key = {key(s): s["score"] for s in ref}
    assert all(abs(s["score"] - by_key[key(s)]) < 1e-3 for s in ours)
    assert compare.catalog_miss(ours, ref, a.scoreThr)[0] == 0.0


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result = run_cell(small_cell(name), 2**31 + 17)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"survey_tiles_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["drop_half_tiles", "moved_boxes"])
def test_a_broken_timed_path_is_not_correct(fault):
    """Half of the batch left out; an answer altered where it is
    produced (harness/faults.py)."""
    result = run_cell(small_cell("v11l-survey"), 2**31 + 17,
                      variant=f"fault:{fault}")
    assert not result["correct"]
    assert result["checks"]["catalog_miss"]["value"] > result["checks"][
        "catalog_miss"]["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 202, 2**31 + 303])
def test_the_control_fails_at_the_cells_size(name, seed, card):
    """The program's int8 path (its own lower-precision path) in the
    program's place, at the cell's own size."""
    result = run_cell(Cell(name), seed, device=card, variant="int8")
    assert not result["correct"], result["checks"]
