"""BENCHMARK.json against the contract, and every file it names found by
name: configurations, workloads, entries and per-layer metric readers."""

import json
import os
import re

import pytest

from harness.core import BENCH_DIR, ROOT, Cell, load_module, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    budget = 2 + 14 * 24
    assert budget * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units(bench):
    names = [m["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for m in bench[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("workloads", "end_to_end", "per_layer"):
        assert len({m["name"] for m in bench[k]}) == len(bench[k])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_configs_found_by_name(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["model"] == c["name"]
        assert cfg["source"] == c["source"]
        assert set(c["reduced"]) <= set(cfg.get("reduced_why", {}))
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_cells(bench):
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        cell = Cell(w["name"])
        entry = cell.entry()
        for fn in ("setup", "window", "kernel_checks", "memory_peak",
                   "attempted", "end_to_end", "release", "check"):
            assert callable(getattr(entry, fn)), fn
        ends = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in ends and len(ends) >= 2
        layers = cell.per_layer()
        assert layers
        for m in layers:
            assert m["moves"] in ends


def test_metric_readers_match_their_entries(bench):
    ends = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        mod = metric_reader(m["name"])
        assert (mod.LAYER, mod.SOURCE, mod.MOVES, mod.UNIT) == (
            m["layer"], m["source"], m["moves"], m["unit"])
        assert m["moves"] in ends and callable(mod.read)


def test_files_under_paths_are_named_from_name_characters():
    for root, dirs, files in os.walk(BENCH_DIR):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", ".cache")]
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


def test_entry_modules_load():
    for f in os.listdir(os.path.join(BENCH_DIR, "entries")):
        if f.endswith(".py"):
            load_module(os.path.join(BENCH_DIR, "entries", f), f[:-3])
