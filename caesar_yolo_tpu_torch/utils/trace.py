"""Spans and a device-clock counter of one detection run.

A span is a named interval on the host's `time.perf_counter`: its start,
its end, its parent (the span open on the same thread when it began), its
thread, and the index of the tile engine's batch it belongs to where it
has one (a batch's `engine.dispatch` and `sfinder.drain` share it).  A
`Recorder` keeps the spans of one run in memory, from any thread;
`totals()` sums them by name across threads, together with the counters,
for `SFinderReport.phase_times`.  `NULL` records nothing: code driven
outside a run (serving, the BatchedDetector alone, training) pays for no
span.

While `Recorder.profiling` is set (the program's own profiler session:
`SFinder.run_tiled` with `profile_dir`), each span is also a
`torch.profiler.record_function` range, so the Chrome trace shows the
spans on the profiler's clock beside the kernels.  Under a session the
program did not open, no range is emitted: a range shows on the device's
timeline too, and a tracer that counts what it finds there as device work
would count it.

`engine.device_starved` is measured on the device's own clock.  Around
each batch the engine dispatches on CUDA, `on_device` records a timing
event on the current stream before the batch's first operation and after
its last.  Once batch k's outputs are on the host, every event up to
batch k's last has completed, and `batch_done(k)` adds the time between
batch k-1's last operation and batch k's first: the stream sat empty then,
waiting for the host, apart from the small copies of an earlier batch's
outputs (and, on the band and stream paths, the workers' staging copies)
that fall in the same interval.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass

DEVICE_STARVED = "engine.device_starved"


@dataclass
class Span:
    name: str
    start: float
    end: float | None       # None while the span is open
    parent: int | None      # index in Recorder.spans of the enclosing span
    thread: int             # threading.get_ident() of the recording thread
    batch: int | None = None


class Recorder:
    """The spans and counters of one run (thread-safe)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, float] = {}
        self.profiling = False
        self._lock = threading.Lock()
        self._open = threading.local()   # .stack: this thread's open spans
        self._events: dict[int, tuple] = {}   # batch -> (start, end) events

    @contextlib.contextmanager
    def span(self, name: str, batch: int | None = None):
        stack = self._open.__dict__.setdefault("stack", [])
        rf = None
        if self.profiling:
            import torch
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        s = Span(name, time.perf_counter(), None,
                 stack[-1] if stack else None, threading.get_ident(), batch)
        with self._lock:
            stack.append(len(self.spans))
            self.spans.append(s)
        try:
            yield
        finally:
            s.end = time.perf_counter()
            stack.pop()
            if rf is not None:
                rf.__exit__(None, None, None)

    def add(self, name: str, value: float) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def totals(self) -> dict[str, float]:
        """Seconds by span name over the closed spans of every thread,
        and the counters."""
        out: dict[str, float] = {}
        with self._lock:
            for s in self.spans:
                if s.end is not None:
                    out[s.name] = out.get(s.name, 0.0) + (s.end - s.start)
            out.update(self.counters)
        return out

    @contextlib.contextmanager
    def on_device(self, batch: int | None, device):
        """Timing events on `device`'s current stream before and after the
        body's operations, kept for batch `batch` (CUDA only)."""
        if batch is None or device.type != "cuda":
            yield
            return
        import torch
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        try:
            yield
        finally:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            with self._lock:
                self._events[batch] = (start, end)
                self.counters.setdefault(DEVICE_STARVED, 0.0)

    def batch_done(self, batch: int) -> None:
        """Batch `batch`'s outputs are on the host: add the device's idle
        time between the end of batch - 1 and the start of this batch to
        `engine.device_starved` (both events have completed, so this
        waits for nothing)."""
        with self._lock:
            prev = self._events.pop(batch - 1, None)
            cur = self._events.get(batch)
        if prev is not None and cur is not None:
            self.add(DEVICE_STARVED, prev[1].elapsed_time(cur[0]) / 1e3)


class _NullRecorder(Recorder):
    """Records nothing."""

    _none = contextlib.nullcontext()

    def span(self, name, batch=None):
        return self._none

    def on_device(self, batch, device):
        return self._none

    def add(self, name, value):
        pass

    def batch_done(self, batch):
        pass


NULL = _NullRecorder()
