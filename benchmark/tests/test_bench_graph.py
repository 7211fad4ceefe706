"""The reader of `graph_replay_share.survey` on synthetic fields: its
BENCHMARK.json entry, the share of replayed batches over the fields that
succeeded, 0 where every batch ran eagerly (the CPU) and nothing where
the program counts neither (a program without the tile step's graph)."""

import json
import os
from types import SimpleNamespace

import pytest

from harness.core import ROOT, metric_reader
from test_bench_survey import CELLS

NAME = "graph_replay_share.survey"


def _ctx(*fields):
    """fields: (rc, phase totals) each, as the survey entry records
    them."""
    return SimpleNamespace(units=[{"rc": rc, "wall": 3.5, "phase": phase}
                                  for rc, phase in fields])


def test_the_reader_matches_its_entry():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = {m["name"]: m for m in json.load(f)["per_layer"]}[NAME]
    mod = metric_reader(NAME)
    assert (mod.LAYER, mod.SOURCE, mod.MOVES, mod.UNIT) == (
        m["layer"], m["source"], m["moves"], m["unit"])
    assert m["workloads"] == list(CELLS) and m["better"] == "higher"


def test_share_of_the_batches_replayed():
    ctx = _ctx((0, {"engine.graph_captures": 1.0,
                    "engine.graph_replays": 30.0,
                    "engine.eager_batches": 4.0, "detect": 2.0}),
               (0, {"engine.graph_replays": 29.0,
                    "engine.eager_batches": 5.0}),
               (1, {"engine.graph_replays": 0.0,
                    "engine.eager_batches": 50.0}))
    assert metric_reader(NAME).read(ctx) == pytest.approx(100.0 * 59 / 68)


@pytest.mark.parametrize("phase,want", [
    ({"engine.eager_batches": 34.0, "detect": 2.0}, 0.0),
    ({"detect": 2.0, "engine.device_starved": 0.2}, None),
    ({}, None)])
def test_eager_only_and_no_counters(phase, want):
    assert metric_reader(NAME).read(_ctx((0, phase), (0, phase))) == want
