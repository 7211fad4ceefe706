"""What every run shares: the cell's files found by name, host spans, the
import check and the card's description.

A cell is found through `BENCHMARK.json` (its configuration and traffic
names) and `workloads/<cell>.json` (its entry, traffic parameters and the
limits of its comparison); its configuration is `configs/<config>.json`;
its entry is `entries/<entry>.py`; each per-layer metric is
`metrics/<metric>.py`.  Nothing here names a cell, a configuration or a
metric: a new one is new files.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

# top-level module names a run may never load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "caesar_yolo_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell's spec: `name`, `config` (the configuration file's
    object), `params` (the workload file's object), `bench` (the
    benchmark's object), its end-to-end and per-layer metric entries."""

    def __init__(self, name: str, unlisted: bool = False):
        self.bench = load_json(ROOT, "BENCHMARK.json")
        self.params = load_json(BENCH_DIR, "workloads", f"{name}.json")
        rows = [w for w in self.bench["workloads"] if w["name"] == name]
        if unlisted:
            # a cell whose files exist but which BENCHMARK.json does not
            # list yet (benchmark/tests drive such cells on the CPU)
            rows = [dict(name=name, **{k: self.params[k] for k in
                                       ("config", "traffic", "chips")})]
        if not rows:
            raise SystemExit(f"unknown workload {name!r}")
        self.name, self.row = name, rows[0]
        for key in ("config", "traffic", "chips"):
            if self.params[key] != self.row[key]:
                raise SystemExit(f"workloads/{name}.json: {key} "
                                 f"{self.params[key]!r} is not "
                                 f"BENCHMARK.json's {self.row[key]!r}")
        self.config = load_json(BENCH_DIR, "configs",
                                f"{self.row['config']}.json")
        self.chips = int(self.row["chips"])

    def _applies(self, m):
        return "workloads" not in m or self.name in m["workloads"]

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"] if self._applies(m)]

    def per_layer(self):
        return [m for m in self.bench["per_layer"] if self._applies(m)]

    def entry(self):
        return load_module(os.path.join(BENCH_DIR, "entries",
                                        f"{self.params['entry']}.py"),
                           f"bench_entry_{self.params['entry']}")


def substream(seed: int, k: int) -> int:
    """The k-th independent seed drawn from a run's --seed."""
    return int(np.random.SeedSequence([seed, k]).generate_state(1)[0])


def metric_reader(name: str):
    return load_module(os.path.join(BENCH_DIR, "metrics", f"{name}.py"),
                       f"bench_metric_{name.replace('.', '_')}")


class Spans:
    """Host spans of the benchmark's own code: (name, start, end) on
    time.perf_counter, and a torch.profiler range of the same name while a
    trace is open."""

    def __init__(self):
        self.done: list[tuple[str, float, float]] = []
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = None
        if self.profiling:
            import torch
            rf = torch.profiler.record_function(f"bench.{name}")
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.done.append((name, t0, time.perf_counter()))
            if rf is not None:
                rf.__exit__(None, None, None)


def import_violations() -> list[str]:
    """Loaded modules whose top-level name is forbidden."""
    return sorted({k for k in list(sys.modules)
                   if k.split(".")[0] in FORBIDDEN})


def nvidia_smi(query: str) -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def log(*args):
    print(*args, file=sys.stderr, flush=True)
