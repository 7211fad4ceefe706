"""Survey fields through `caesar_yolo_tpu_torch.cli.run` on four ranks of
one process group, one process a card, one call a field on every rank.

The run's own process is rank 0 on the first card; it starts ranks 1 to 3
as processes of this file (`python entries/survey_ranks.py`, the rank in
the environment as a launcher sets it: RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT), each on its own card, which run the fields
rank 0 hands them on standard input and answer on standard output.  The
program does the rest: `cli.run` joins the group, each rank detects the
tiles with tid % 4 == rank, the chunked allgather brings every rank's
results to every rank, and rank 0 writes the catalog.  A field counts
when every rank has finished it.  The window, the traced session and the
program's spans and counters that the metrics read are rank 0's; each
field's record also keeps every rank's span totals ("ranks").

Each rank runs on its share of the host's cores (`host_share`).  Every
field has a deadline (`deadline_s` from its start; the ranks' end has one
too): a rank that hangs makes the run exit with status 3 at the
deadline, without a result, never a hang; a rank that dies fails the
field at once.  The variant `stopped_rank` (benchmark/tests) stops the
last rank before the window's first field.

Workload parameters as the survey entry's (entries/survey.py), and
  ranks        processes, one a card (the cell's chips)
  deadline_s   the bound of each field
Check: rank 0's catalog of each field against the f32 reference's catalog
of the whole field (reference/survey.py, the reference's tiles split over
the cards), by `catalog_miss`.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

if __name__ == "__main__":
    HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness.core import BENCH_DIR, ROOT, load_module, log  # noqa: E402

base = load_module(os.path.join(BENCH_DIR, "entries", "survey.py"),
                   "bench_entry_survey_of_survey_ranks")
ref = base.survey       # reference/survey.py
KERNEL_COUNTERS = base.KERNEL_COUNTERS


# -- the ranks' side ---------------------------------------------------------

def serve_rank():
    """A rank other than 0: run each field rank 0 sends (a JSON line of
    cli.run's argv) and answer with a JSON line of its outcome, until its
    input closes."""
    reply = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)           # the program's own prints go to standard error
    import torch

    from caesar_yolo_tpu_torch.cli import run as cli_run
    torch.set_num_threads(host_share(int(os.environ["WORLD_SIZE"])))
    reply.write(json.dumps({"ready": True}) + "\n")
    for line in sys.stdin:
        rc, sf = cli_run.run(json.loads(line)["argv"])
        rep = sf.report if sf is not None else None
        peak = (torch.cuda.max_memory_allocated()
                if torch.cuda.is_available() else 0)
        reply.write(json.dumps({
            "rc": rc, "phase": dict(rep.phase_times) if rep else {},
            "memory_peak": peak}) + "\n")
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def host_share(ranks: int) -> int:
    """Each rank's share of the host's cores, as a launcher gives it (four
    processes of as many threads as cores would contend for them)."""
    return max(1, len(os.sched_getaffinity(0)) // ranks)


# -- rank 0's side -----------------------------------------------------------

class Deadline:
    """Ends the process with status 3 when `seconds` pass before
    `clear()`: a rank that hangs holds rank 0 inside a collective, which
    nothing else would end."""

    def __init__(self, ctx, what, seconds):
        self.timer = threading.Timer(seconds, self._expire, (ctx, what,
                                                             seconds))
        self.timer.daemon = True
        self.timer.start()

    @staticmethod
    def _expire(ctx, what, seconds):
        log(f"{what} passed its deadline of {seconds:.0f} s: the ranks are "
            f"stopped and the run ends without a result")
        for p in getattr(ctx, "ranks", []):
            p.kill()
        os._exit(3)

    def clear(self):
        self.timer.cancel()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_env(rank, world, port):
    return {"RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "MASTER_ADDR": "localhost",
            "MASTER_PORT": str(port)}


def _rank0_batches(ctx, a):
    """(h, w) of each of rank 0's device batches: its tiles (tid % ranks
    == 0) by shape, padded to batch_size."""
    from collections import Counter
    p = ctx.cell.params
    n = p["field"]["field_px"]
    windows = ref.tile_grid(n, n, a)
    shapes = Counter((y1 - y0, x1 - x0) for t, (x0, x1, y0, y1)
                     in enumerate(windows) if t % p["ranks"] == 0)
    return [hw for hw, k in shapes.items()
            for _ in range(-(-k // a.batch_size))]


def setup(ctx):
    p = ctx.cell.params
    world = p["ranks"]
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, **_rank_env(0, world, port))
    ctx.ranks = []
    ctx.rank_peaks = [0] * world
    with ctx.spans("setup.ranks"):
        for r in range(1, world):
            ctx.ranks.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__)],
                env=dict(env, **_rank_env(r, world, port)), cwd=ctx.tmp,
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True))
    ctx.saved_env = {k: os.environ.get(k) for k in _rank_env(0, 1, 0)}
    os.environ.update(_rank_env(0, world, port))
    import torch
    ctx.saved_threads = torch.get_num_threads()
    torch.set_num_threads(host_share(world))
    # the survey entry's set-up (traffic, weights, import, warm fields):
    # its fields go through run_field below
    base.run_field = run_field
    base.setup(ctx)
    a = ref.parse_flags(p["flags"])
    ctx.batches = _rank0_batches(ctx, a)


def _send(ctx, argv):
    for proc in ctx.ranks:
        proc.stdin.write(json.dumps({"argv": argv}) + "\n")
        proc.stdin.flush()


def _receive(proc):
    while True:
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"rank process {proc.pid} ended "
                               f"(status {proc.poll()})")
        msg = json.loads(line)
        if "ready" not in msg:
            return msg


def run_field(ctx, tag):
    """One field on every rank; rank 0's record, with every rank's span
    totals, and the worst rank's status."""
    p = ctx.cell.params
    argv = ctx.argv + [f"--detect_outfile_json=catalog_{tag}.json",
                       f"--detect_outfile=ds9_{tag}.reg"]
    deadline = Deadline(ctx, f"field {tag}", p["deadline_s"])
    t0 = time.perf_counter()
    _send(ctx, argv)
    with ctx.spans("field"):
        rc, sf = ctx.cli_run.run(argv)
    others = [_receive(proc) for proc in ctx.ranks]
    wall = time.perf_counter() - t0
    deadline.clear()
    rep = sf.report if sf is not None else None
    phases = [dict(rep.phase_times) if rep else {}] + [o["phase"]
                                                       for o in others]
    for r, o in enumerate(others, 1):
        ctx.rank_peaks[r] = max(ctx.rank_peaks[r], o["memory_peak"])
    return {"tag": tag, "wall": wall,
            "rc": max([rc] + [o["rc"] for o in others]),
            "catalog": f"catalog_{tag}.json",
            "tiles": rep.n_tiles if rep else 0,
            "read_s": rep.read_s if rep else 0.0,
            "phase": phases[0], "ranks": phases}


def window(ctx, seconds, tracer):
    if ctx.variant == "stopped_rank":
        os.kill(ctx.ranks[-1].pid, signal.SIGSTOP)
    base.window(ctx, seconds, tracer)


attempted = base.attempted
end_to_end = base.end_to_end


def kernel_checks(ctx):
    return dict(KERNEL_COUNTERS)


def memory_peak(ctx):
    if ctx.device != "cuda":
        return 0
    import torch
    return max([torch.cuda.max_memory_allocated(0)] + ctx.rank_peaks)


def release(ctx):
    """Every rank leaves the group at once (the ranks when their input
    closes: tearing a group down may be collective), then rank 0's
    environment and threads are as before."""
    import torch
    import torch.distributed as dist
    deadline = Deadline(ctx, "the ranks' end", ctx.cell.params["deadline_s"])
    for proc in ctx.ranks:
        proc.stdin.close()
    if dist.is_initialized():
        dist.destroy_process_group()
    for proc in ctx.ranks:
        proc.wait()
    deadline.clear()
    torch.set_num_threads(ctx.saved_threads)
    for k, v in ctx.saved_env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    base.release(ctx)


def reference_catalog(ctx):
    """The f32 reference's catalog of the whole field, its tiles split
    over the run's cards (one thread a card)."""
    import torch

    from reference.model import YOLO, exact_f32, load_npz
    cfg, p = ctx.cell.config, ctx.cell.params
    a = ref.parse_flags(p["flags"])
    field = base.field_of(ctx)
    windows = ref.tile_grid(*field.shape, a)
    devices = ([torch.device("cuda", d) for d in range(ctx.cell.chips)]
               if ctx.device == "cuda" else [torch.device(ctx.device)])
    parts = [list(range(k, len(windows), len(devices)))
             for k in range(len(devices))]

    def detect(dev, idx):
        model = load_npz(YOLO(cfg["model"], cfg["nc"]), ctx.weights)
        model = model.to(dev).eval()
        return ref.detect_tiles(model, field, [windows[i] for i in idx], a,
                                dev)

    dets = [None] * len(windows)
    with exact_f32(), ThreadPoolExecutor(len(devices)) as pool:
        for idx, out in zip(parts, pool.map(detect, devices, parts)):
            for i, d in zip(idx, out):
                dets[i] = d
    tile_objs = [ref.tile_objects(d, w, a) if d is not None else []
                 for d, w in zip(dets, windows)]
    return ref.stitch(tile_objs, windows)


base.reference_catalog = reference_catalog
check = base.check


if __name__ == "__main__":
    serve_rank()
