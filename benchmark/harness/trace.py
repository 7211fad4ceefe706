"""The traced run's profiler session over the first units of the window.

torch.profiler drops the first kernel records of a session (more as the
process ages), so the session opens with PRIME launches of a short spin,
which are left out.  Kernels named by a metric are counted in the trace
and by the program's own launch counters over the same units; a run where
the two differ stops with an error and reports no device metric.  While
the session is open, `nvidia-smi` samples the card's clocks and power.
"""

from __future__ import annotations

import importlib
import subprocess
import time
from collections import Counter

import numpy as np

from harness.core import log

PRIME = 256
SPIN = "spin_kernel"
SMI_QUERY = "clocks.sm,power.draw,power.limit,temperature.gpu"


def kernel_name(name: str) -> str:
    """'void (anonymous namespace)::k<1>(float*)' -> 'k'."""
    short = name.replace("(anonymous namespace)::", "").split("(")[0]
    short = short.split("<")[0].removeprefix("void ").split("::")[-1]
    return short.strip() or name


def read_counter(path: str) -> int:
    """'package.module:obj.attr' -> the program's counter."""
    mod, attrs = path.split(":")
    obj = importlib.import_module(mod)
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return int(obj)


class Trace:
    """What the session saw: `window_s` (host clock over the traced
    units), `busy_s` (union of kernel intervals), `kernel_s` and
    `kernel_n` by short name, `units` traced, `idle` by host label."""

    def __init__(self):
        self.window_s = self.busy_s = 0.0
        self.kernel_s: Counter = Counter()
        self.kernel_n: Counter = Counter()
        self.units = 0
        self.idle: Counter = Counter()


class Tracer:
    """begin() before the first unit of the window, after_unit() after
    each; the session stops after `units` units and is read by finish()
    once the window has closed.  `checks` maps a
    kernel's short name to the counter path that counts its launches."""

    def __init__(self, enabled: bool, units: int, spans, checks: dict,
                 device_type: str = "cuda"):
        self.enabled, self.units_wanted = enabled, units
        self.spans, self.checks = spans, checks
        self.device_type = device_type
        self.prof = self.smi = None
        self.result = None
        self.stopped = False
        self.overhead_s = 0.0   # the window's time spent stopping the session

    def begin(self):
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device_type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            self.smi = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={SMI_QUERY}",
                 "--format=csv,noheader", "-lms", "500"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.prof = profile(activities=acts)
        self.prof.start()
        if self.device_type == "cuda":
            for _ in range(PRIME):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        self.before = {k: read_counter(p) for k, p in self.checks.items()}
        self.spans.profiling = True
        self.n = 0
        self.t0 = time.perf_counter()

    def after_unit(self):
        if self.prof is None or self.stopped:
            return
        self.n += 1
        if self.n >= self.units_wanted:
            self._stop()

    def finish(self):
        """After the window: close the session if the window ended first,
        then read it (outside the measured window)."""
        if self.prof is None:
            return
        if not self.stopped:
            self._stop()
        self._read()

    def _stop(self):
        import torch
        if self.device_type == "cuda":
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.spans.profiling = False
        self.prof.stop()
        self.launched = {k: read_counter(p) - self.before[k]
                         for k, p in self.checks.items()}
        self.stopped = True
        self.overhead_s = time.perf_counter() - self.t1

    def _read(self):
        import torch
        if self.smi is not None:
            self.smi.terminate()
            out, _ = self.smi.communicate(timeout=30)
            for line in out.strip().splitlines():
                log("nvidia-smi", SMI_QUERY, ":", line.strip())
        tr = Trace()
        tr.window_s, tr.units = self.t1 - self.t0, self.n
        gpu, cpu = [], []
        for e in self.prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # the benchmark's own ranges show on the device's timeline
                # too: they are no device operation
                if SPIN in e.name or e.name.startswith("bench."):
                    continue
                name = kernel_name(e.name)
                tr.kernel_s[name] += e.time_range.elapsed_us() / 1e6
                tr.kernel_n[name] += 1
                gpu.append((e.time_range.start, e.time_range.end))
            else:
                cpu.append((e.time_range.start, e.time_range.end, e.name))
        for k, n in self.launched.items():
            if tr.kernel_n[k] != n:
                raise RuntimeError(
                    f"trace kept {tr.kernel_n[k]} {k} records of {n} "
                    f"launches counted by the program: no device metric "
                    f"from this run")
        tr.busy_s, gaps = _union(gpu)
        tr.idle = _label_gaps(gaps, cpu)
        self.result = tr
        self.prof = None


def _union(intervals):
    """-> (seconds covered, gaps [(start, end)] in us between them)."""
    if not intervals:
        return 0.0, []
    iv = sorted(intervals)
    busy, gaps = 0.0, []
    s, e = iv[0]
    for a, b in iv[1:]:
        if a > e:
            busy += e - s
            gaps.append((e, a))
            s, e = a, b
        else:
            e = max(e, b)
    busy += e - s
    return busy / 1e6, gaps


def _label_gaps(gaps, cpu, longest=200):
    """Idle seconds by what the host was doing when each of the longest
    gaps began: the benchmark's span and the innermost host op open
    then."""
    out = Counter()
    if not gaps or not cpu:
        return out
    starts = np.asarray([c[0] for c in cpu])
    ends = np.asarray([c[1] for c in cpu])
    names = [c[2] for c in cpu]
    bench = np.asarray([n.startswith("bench.") for n in names])
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
    for g0, g1 in gaps:
        live = (starts <= g0) & (ends > g0)
        span = _innermost(live & bench, starts, ends, names)
        op = _innermost(live & ~bench, starts, ends, names)
        out[f"{span or 'outside'}/{op or 'idle host'}"] += (g1 - g0) / 1e6
    return out


def _innermost(mask, starts, ends, names):
    idx = np.nonzero(mask)[0]
    if not len(idx):
        return None
    return names[idx[np.argmin(ends[idx] - starts[idx])]]


def breakdown(tr: Trace) -> dict:
    return {"device_ops": [[k, v] for k, v in tr.kernel_s.most_common(10)],
            "idle_gaps": [[k, v] for k, v in tr.idle.most_common(10)]}


def by_name(tr: Trace, names) -> tuple[float, int]:
    """(device seconds, records) of the kernels with these short names."""
    return (sum(tr.kernel_s[n] for n in names),
            sum(tr.kernel_n[n] for n in names))

