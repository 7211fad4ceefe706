"""A survey cell's field under the program's own profiler session
(`cli.run --profile_dir`), its device idle gaps named by the program's
spans, and what the session costs a field.

The cell's traffic and weights are made as the benchmark makes them
(benchmark/run.py's set-up, the warm field included).  Then `--plain`
fields run as the benchmark runs them, and `--profiled` fields with
`--profile_dir`, in turns.  Each profiled field's Chrome trace holds the
program's spans (user annotations, on the profiler's clock) beside the
kernels and copies.  Every gap between device operations inside the
field is put down to the innermost span open on the run's thread when
the gap began, and to the innermost runtime call or operator open then;
the copies the host waited in are told apart by their span
(`engine.stage` the mosaic's put, `engine.origins` a batch's origins,
`sfinder.drain_wait` a batch's outputs).  One JSON line a field, the
last line the summary; with --out the lines also go to that file.
`--sync_fields` more fields run under `torch.cuda.set_sync_debug_mode`,
which warns at every operation that makes the host wait for the device:
the summary counts them by the program's two innermost source lines.

    python3 scripts/torch_span_gaps.py --workload v11l-survey --seed 7 \
        [--plain 3] [--profiled 2] [--out gaps.jsonl]

The session drops the first kernel records of a process (the CLI's
session opens without priming spins), so the first gaps of the first
profiled field may be records lost, not idle time: the line gives each
field's gaps, and the summary the later fields' alone where there are
several.  `--small` runs the cell at the CPU tests' size, with
`--device cpu`, to rehearse the script.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
import traceback
import warnings
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
sys.path[:0] = [BENCH, os.path.join(BENCH, "tests"), ROOT]

PACKAGE = os.path.join(ROOT, "caesar_yolo_tpu_torch")
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}


def gaps_by_span(events, t0, t1, long_us=50.0):
    """Device idle gaps inside [t0, t1] (us) -> (busy us, idle us,
    Counter of idle us by the innermost span open over each part of a gap,
    Counter of idle us by 'span/operator/runtime call' open when the gap
    began, for gaps of `long_us` or more)."""
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("cat") in DEVICE_CATS and t0 <= e["ts"] <= t1)
    busy, gaps = 0.0, []
    if dev:
        s, end = dev[0]
        gaps.append((t0, s))
        for a, b in dev[1:]:
            if a > end:
                busy += end - s
                gaps.append((end, a))
                s, end = a, b
            else:
                end = max(end, b)
        busy += end - s
        gaps.append((end, t1))
    gaps = [(g0, g1) for g0, g1 in gaps if g1 > g0]
    spans = Intervals(e for e in events if e.get("cat") == "user_annotation")
    ops = Intervals(e for e in events if e.get("cat") == "cpu_op")
    calls = Intervals(e for e in events if e.get("cat") == "cuda_runtime")
    edges = np.unique(np.concatenate([spans.start, spans.end]))
    by_span, by_call = Counter(), Counter()
    for g0, g1 in gaps:
        cuts = edges[(edges > g0) & (edges < g1)]
        for a, b in zip([g0, *cuts], [*cuts, g1]):
            by_span[spans.innermost((a + b) / 2)] += b - a
        span = spans.innermost(g0)
        call = (f"{ops.innermost(g0)}/{calls.innermost(g0)}"
                if g1 - g0 >= long_us else "short gaps")
        by_call[f"{span}/{call}"] += g1 - g0
    return busy, sum(g1 - g0 for g0, g1 in gaps), by_span, by_call


class Intervals:
    """Named host intervals; `innermost(t)` is the shortest one open at t
    ("none" if none is)."""

    def __init__(self, events):
        events = list(events)
        self.names = [e["name"] for e in events]
        self.start = np.asarray([e["ts"] for e in events], float)
        self.end = self.start + np.asarray([e["dur"] for e in events], float)

    def innermost(self, t):
        live = np.nonzero((self.start <= t) & (self.end > t))[0]
        if not len(live):
            return "none"
        return self.names[live[np.argmin(self.end[live] - self.start[live])]]


def recorder_cost(device, n=20000):
    """(us a span, two deep; us a batch's device events, their record
    on an idle stream and batch_done's read, with a stream synchronize
    the drain does not add: an upper bound) of utils/trace.Recorder."""
    from caesar_yolo_tpu_torch.utils.trace import Recorder
    rec = Recorder()
    t0 = time.perf_counter()
    for _ in range(n // 2):
        with rec.span("outer"), rec.span("inner", 0):
            pass
    span_us = (time.perf_counter() - t0) / n * 1e6
    rec, m = Recorder(), n // 10
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(m):
        with rec.on_device(k, device):
            pass
        if device.type == "cuda":     # the drain finds them complete
            torch.cuda.current_stream(device).synchronize()
        rec.batch_done(k)
    batch_us = (time.perf_counter() - t0) / m * 1e6
    return span_us, batch_us


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--plain", type=int, default=3)
    p.add_argument("--profiled", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--sync_fields", type=int, default=1)
    p.add_argument("--small", action="store_true")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    # the cell's set-up works in a directory of its own
    args.out = os.path.abspath(args.out) if args.out else ""

    import torch

    import run as bench
    from harness.core import Cell
    cell = Cell(args.workload)
    if args.small:
        from test_bench_survey import small_cell
        cell = small_cell(args.workload)
    ctx = bench.Context(cell, bench.parse(
        ["--workload", args.workload, "--seed", str(args.seed),
         "--seconds", "0"]), args.device)
    cell.entry().setup(ctx)         # traffic, weights, the warm field
    prof_dir = os.path.join(ctx.tmp, "prof")
    lines, kept = [], []
    if args.out:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    out = open(args.out, "w") if args.out else None
    order = []      # in turns: plain, profiled, plain, ...
    for i in range(max(args.plain, args.profiled)):
        order += ["plain"] * (i < args.plain) + ["profiled"] * (
            i < args.profiled)
    for k, kind in enumerate(order):
        argv_k = ctx.argv + [f"--detect_outfile_json=catalog_{k}.json",
                             f"--detect_outfile=ds9_{k}.reg"]
        if kind == "profiled":
            argv_k.append(f"--profile_dir={prof_dir}")
        t0 = time.perf_counter()
        rc, sf = ctx.cli_run.run(argv_k)
        wall = time.perf_counter() - t0
        rep = sf.report
        line = {"field": k, "kind": kind, "rc": rc, "wall_s": wall,
                "tiles": rep.n_tiles, "phase_times": rep.phase_times,
                "spans": [s.name for s in rep.spans]}
        if kind == "profiled":
            path = os.path.join(prof_dir, "field.trace.json")
            with open(path) as f:
                events = [e for e in json.load(f)["traceEvents"]
                          if e.get("ph") == "X"]
            det = [e for e in events if e.get("cat") == "user_annotation"
                   and e["name"] == "detect"]
            t_a = min(e["ts"] for e in events)
            t_b = max(e["ts"] + e["dur"] for e in events)
            busy, idle, by_span, by_call = gaps_by_span(events, t_a, t_b)
            line.update(
                trace_s=(t_b - t_a) / 1e6, busy_s=busy / 1e6,
                idle_s=idle / 1e6,
                kernels=sum(e.get("cat") == "kernel" for e in events),
                span_events=sum(e.get("cat") == "user_annotation"
                                for e in events),
                detect_in_trace_s=[e["dur"] / 1e6 for e in det],
                idle_by_span={s: v / 1e6 for s, v in by_span.most_common()},
                idle_by_span_call={s: v / 1e6 for s, v in
                                   by_call.most_common(15)})
            kept.append(line)
            os.remove(path)
        lines.append(line)
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")

    syncs = Counter()

    def where(message, *rest, **kw):
        """The innermost frames of the program at a synchronizing
        operation."""
        if "synchroniz" not in str(message):
            return
        frames = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"
                  for f in traceback.extract_stack()
                  if f.filename.startswith(PACKAGE)]
        syncs[" < ".join(frames[::-1][:2])] += 1

    for k in range(args.sync_fields):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = where
            torch.cuda.set_sync_debug_mode("warn")
            try:
                ctx.cli_run.run(ctx.argv + [
                    f"--detect_outfile_json=catalog_s{k}.json",
                    f"--detect_outfile=ds9_s{k}.reg"])
            finally:
                torch.cuda.set_sync_debug_mode(0)

    late = kept[1:] or kept
    idle = Counter()
    for line in late:
        idle.update(line["idle_by_span"])
    plain = [x for x in lines if x["kind"] == "plain"]
    wall = statistics.median(x["wall_s"] for x in plain) if plain else None
    # spans and batches of a field (the plain fields' own reports)
    n_spans = len(plain[-1]["spans"]) if plain else 0
    n_batches = sum(s == "engine.dispatch" for s in plain[-1]["spans"]) \
        if plain else 0
    span_us, batch_us = recorder_cost(torch.device(args.device))
    summary = {
        "workload": args.workload, "seed": args.seed,
        "plain_wall_s": [x["wall_s"] for x in plain],
        "profiled_wall_s": [x["wall_s"] for x in kept],
        "profile_cost": statistics.median(x["wall_s"] for x in late)
        / wall - 1.0 if plain and kept else None,
        "recorder_us": {"span": span_us, "batch_events": batch_us},
        "recorder_share_of_field": (n_spans * span_us + n_batches
                                    * batch_us) / 1e6 / wall
        if plain else None,
        "idle_by_span_s_per_field": {s: v / len(late)
                                     for s, v in idle.most_common()},
        "host_waits_per_field_by_line": {
            s: v / args.sync_fields for s, v in syncs.most_common(20)}
        if args.sync_fields else {},
    }
    print(json.dumps(summary), flush=True)
    if out:
        out.write(json.dumps(summary) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
