#!/usr/bin/env python3
"""One run of one cell of the benchmark of `caesar_yolo_tpu_torch`.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the cell's traffic and weights made from the seed, the
program's kernels loaded, warm units outside the window) is `setup_s`;
then the cell's entry measures for `--seconds` and finishes the unit in
progress; then the program's state is freed and its outputs are compared
with the plain reference under `reference/`.  With `--trace 0` the
result line carries the cell's end-to-end metrics, with `--trace 1` its
per-layer metrics, read by `metrics/<name>.py` from the benchmark's spans,
the program's counters and a profiler session over the first units of
the window.  The last line of standard output is the result; the numbers
compared, each beside its limit, are the last lines of standard error and
the result's last key.  Exits 1 without a result when CUDA or the cell's
cards are missing, when the run loaded JAX or the JAX package, or when the
trace lost records.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
# caches inside the checkout, at fixed paths; no library may pull in JAX
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(HERE, ".cache",
                                                       "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "torch_extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

from harness.core import (Cell, Spans, import_violations, log,  # noqa: E402
                          metric_reader, nvidia_smi)
from harness.trace import Tracer, breakdown  # noqa: E402


class Context:
    """What an entry and the metric readers share for one run."""

    def __init__(self, cell, args, device):
        self.cell, self.args, self.device = cell, args, device
        self.seed, self.seconds = args.seed, args.seconds
        self.spans = Spans()
        self.units: list[dict] = []     # one record per unit of the window
        self.window_s = 0.0
        self.window_t0 = 0.0
        self.trace = None               # harness.trace.Trace, traced runs
        self.variant = args.variant
        base = os.environ.get("TMPDIR") or tempfile.gettempdir()
        self.tmp = tempfile.mkdtemp(prefix="bench-", dir=base)


def parse(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the control of `correct` (the program's own lower-precision path,
    # or the reference in a lower precision) or a planted fault
    # (harness/faults.py), for benchmark/tests and the limits' readings:
    # never in a measured run
    p.add_argument("--variant", default="")
    return p.parse_args(argv)


def run(argv=None, device="cuda", cell=None, out=sys.stdout):
    """One run; `device` and `cell` (a harness.core.Cell) are for the
    tests, which run a cell's entry on the CPU at a small size."""
    args = parse(argv)
    cell = cell or Cell(args.workload)
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            log("no CUDA device: no result")
            return 1
        if torch.cuda.device_count() < cell.chips:
            log(f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                f"for {cell.chips}: no result")
            return 1
    entry = cell.entry()
    unplant = None
    if args.variant.startswith("fault:"):
        from harness.faults import plant
        unplant = plant(args.variant.split(":", 1)[1])
    ctx = Context(cell, args, device)
    owd = os.getcwd()
    try:
        entry.setup(ctx)
        setup_s = time.perf_counter() - T_START
        log(f"setup_s {setup_s:.3f}:", ", ".join(
            f"{n} {b - a:.3f}" for n, a, b in ctx.spans.done))
        tracer = Tracer(bool(args.trace), int(cell.params["trace_units"]),
                        ctx.spans, entry.kernel_checks(ctx)
                        if args.trace else {}, device)
        entry.window(ctx, args.seconds, tracer)
        tracer.finish()
        ctx.trace = tracer.result
        peak = entry.memory_peak(ctx)
        attempted, failed = entry.attempted(ctx)
        e2e = entry.end_to_end(ctx)
        entry.release(ctx)
        t_check = time.perf_counter()
        checks = entry.check(ctx)
        log(f"check took {time.perf_counter() - t_check:.3f} s")
    finally:
        if unplant is not None:
            unplant()
        os.chdir(owd)
        shutil.rmtree(ctx.tmp, ignore_errors=True)
    bad = import_violations()
    if bad:
        log("loaded forbidden modules:", ", ".join(bad), "- no result")
        return 1
    metrics = {}
    if args.trace:
        for m in cell.per_layer():
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(e2e, setup_s=setup_s)
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else device, "count": cell.chips, "memory_peak_bytes": peak}
    if device == "cuda":
        log("card:", nvidia_smi("name,power.limit,clocks.sm,power.draw"))
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if args.trace and ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = breakdown(ctx.trace)
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    for name, v, lim in checks:
        log(f"check {name} = {v!r} limit {lim!r} "
            f"{'ok' if v <= lim else 'FAILED'}")
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
