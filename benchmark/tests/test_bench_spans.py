"""The six readers of the program's own span totals and starvation
counter: each matches its BENCHMARK.json entry, and a traced CPU run of
each survey cell at the small size of test_bench_survey.py reports the
five span shares as numbers and leaves out `starved_share.survey`, whose
counter exists on the card alone."""

import io
import json
import os

import pytest

import run as bench
from harness.core import ROOT, metric_reader
from test_bench_survey import CELLS, small_cell

SPANS = ("setup_span_share.survey", "stage_share.survey",
         "dispatch_share.survey", "drain_wait_share.survey",
         "drain_host_share.survey")
COUNTER = "starved_share.survey"


def test_the_readers_match_their_entries():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        rows = {m["name"]: m for m in json.load(f)["per_layer"]}
    for name in SPANS + (COUNTER,):
        m, mod = rows[name], metric_reader(name)
        assert (mod.LAYER, mod.SOURCE, mod.MOVES, mod.UNIT) == (
            m["layer"], m["source"], m["moves"], m["unit"])
        assert m["workloads"] == list(CELLS) and m["better"] == "lower"
        assert mod.SOURCE == ("program_counter" if name == COUNTER
                              else "program_span")


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_cpu_run_reports_the_span_shares(name):
    out = io.StringIO()
    argv = ["--workload", name, "--seed", str(2**31 + 29), "--seconds", "0",
            "--trace", "1"]
    assert bench.run(argv, device="cpu", cell=small_cell(name), out=out) == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    for m in SPANS:
        v = metrics[m]["value"]
        assert isinstance(v, float) and 0.0 <= v < 100.0, (m, v)
    assert COUNTER not in metrics
    # the set-up spans lie inside the outside measure of set-up
    assert metrics["setup_span_share.survey"]["value"] <= metrics[
        "cli_setup_share.survey"]["value"]
