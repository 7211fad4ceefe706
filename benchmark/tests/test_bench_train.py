"""The training cell's comparison (a cell BENCHMARK.json does not list
yet: PERF.md, Open questions): the plain reference follows the program's
first steps, the check passes a sound run and fails a broken one.

On the CPU at a small size (yolo11n at 128 px, batches of 4, float32
forward): the program's losses, first gradient and parameter change equal
the reference's to rounding; with half of each batch left out (the mean
taken over the rest), or the targets moved where the augmentation
produces them, the run is not correct.  A step that returns its state
unchanged reads 1 on update_gap by the measure itself and needs no run.
"""

import io
import json

import pytest

import run as bench
from harness.core import Cell


def small_cell(dtype="float32"):
    cell = Cell("v11l-train", unlisted=True)
    cell.config = dict(cell.config, model="yolo11n", imgsz=128,
                       compute_dtype=dtype)
    cell.params = dict(cell.params, batch=4,
                       data=dict(cell.params["data"], n_images=24))
    return cell


def run_cell(cell, seed, device="cpu", variant=""):
    out = io.StringIO()
    argv = ["--workload", cell.name, "--seed", str(seed), "--seconds", "0",
            "--trace", "0"] + (["--variant", variant] if variant else [])
    assert bench.run(argv, device=device, cell=cell, out=out) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_reference_follows_the_program_in_f32():
    result = run_cell(small_cell(), 2**31 + 5)
    checks = result["checks"]
    assert result["correct"]
    assert checks["loss_gap"]["value"] < 1e-4
    assert checks["grad_gap"]["value"] < 1e-3
    assert checks["update_gap"]["value"] < 1e-2
    assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("fault", ["half_batch", "moved_targets"])
def test_a_broken_step_is_not_correct(fault):
    """Half of the batch left out, the mean over the rest; an answer
    (the targets) altered where it is produced (harness/faults.py)."""
    result = run_cell(small_cell(), 2**31 + 5, variant=f"fault:{fault}")
    assert not result["correct"], result["checks"]


