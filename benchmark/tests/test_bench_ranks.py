"""The four-rank cell v11l-survey-4gpu (a cell BENCHMARK.json does not
list yet: PERF.md, Open questions) on the CPU: four gloo ranks (one
process each) at a small size (yolo11n, a 1024 px field of 16 tiles in
batches of 4).  A sound traced run is correct and reports rank 0's
metrics and the ranks' spread; a rank that stops ends the run at its
deadline with status 3 and no result, never a hang."""

import io
import json
import os
import subprocess
import sys
import time

import run as bench
from harness.core import BENCH_DIR, Cell, metric_reader

NAME = "v11l-survey-4gpu"
# the readers the cell would list: v11l-survey's and the ranks' spread
SPREAD = {"name": "rank_spread.survey", "unit": "%"}


def small_cell(deadline_s=240):
    cell = Cell(NAME, unlisted=True)
    rows = Cell("v11l-survey").per_layer() + [SPREAD]
    cell.per_layer = lambda: rows
    cell.config = dict(cell.config, model="yolo11n")
    flags = [f if not f.startswith("--batch_size=") else "--batch_size=4"
             for f in cell.params["flags"]]
    cell.params = dict(cell.params, flags=flags, deadline_s=deadline_s,
                       field=dict(cell.params["field"], field_px=1024,
                                  n_sources=64))
    return cell


def test_a_sound_traced_run_on_four_ranks_is_correct():
    out = io.StringIO()
    argv = ["--workload", NAME, "--seed", str(2**31 + 29), "--seconds",
            "0", "--trace", "1"]
    assert bench.run(argv, device="cpu", cell=small_cell(), out=out) == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    m = result["metrics"]
    assert m["rank_spread.survey"]["value"] >= 100.0
    assert m["graph_replay_share.survey"]["value"] == 0.0
    for name in ("dispatch_share.survey", "read_share.survey",
                 "cli_setup_share.survey"):
        assert 0.0 < m[name]["value"] < 100.0, name
    assert "WORLD_SIZE" not in os.environ or os.environ["WORLD_SIZE"] != "4"


def test_the_spread_reader():
    mod = metric_reader(SPREAD["name"])
    assert (mod.LAYER, mod.SOURCE, mod.MOVES, mod.UNIT) == (
        "ranks (parallel/mesh.py, parallel/sfinder.py)", "program_span",
        "survey_tiles_per_s", SPREAD["unit"])


def run_stopped():
    """The stopped-rank run (a subprocess of the test below)."""
    argv = ["--workload", NAME, "--seed", "7", "--seconds", "30",
            "--variant", "stopped_rank"]
    return bench.run(argv, device="cpu", cell=small_cell(deadline_s=45))


def test_a_stopped_rank_ends_the_run_at_its_deadline():
    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path[:0] = [{here!r}, {BENCH_DIR!r}, "
            f"{os.path.dirname(BENCH_DIR)!r}]; import test_bench_ranks as t;"
            f" sys.exit(t.run_stopped())")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 3, proc.stderr[-3000:]
    assert "passed its deadline of 45 s" in proc.stderr
    assert time.perf_counter() - t0 < 400
