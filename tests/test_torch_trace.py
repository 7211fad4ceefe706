"""The run's spans and device-clock counter (utils/trace.py), on a small
tiled cli.run on the CPU: a 208 px synthetic mosaic in 9 tiles of 96 px at
step 0.75 (four tile shapes, so four batches of up to 4) with the trained
yolov8n_synth96 fixture.

Each batch has one `engine.dispatch` and one `sfinder.drain` under one
index; the top-level spans of the run's thread do not overlap and fit in
the call's wall; the report keeps its old phase keys and `read_s`; the
band and stream paths' worker spans are summed into the run's totals; a
profiler session the program did not open sees no span, the program's
own (`--profile_dir`) sees them all; the starvation counter pairs batch
k-1's end with batch k's start, and is absent on the CPU; the weights'
read, upload and fold nest in the set-up spans.
"""

import json
import os
import sys
import threading
import time

import pytest
import torch

from caesar_yolo_tpu_torch.cli import run as cli_run
from caesar_yolo_tpu_torch.models.convert import load_model
from caesar_yolo_tpu_torch.ops.transforms import build_preprocessor
from caesar_yolo_tpu_torch.parallel.sfinder import SFinder, SFinderConfig
from caesar_yolo_tpu_torch.utils import trace
from caesar_yolo_tpu_torch.utils.synth import write_mosaic_fits

torch.set_num_threads(1)

WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "yolov8n_synth96.npz")
N = 208
FLAGS = ["--imgsize=96", "--devices=cpu", "--scoreThr=0.3",
         "--preprocessing", "--normalize_minmax", "--split_img_in_tiles",
         "--tile_xsize=96", "--tile_ysize=96", "--tile_xstep=0.75",
         "--tile_ystep=0.75", "--batch_size=4"]
TOP = {"cli.load_weights", "cli.build", "cli.preprocessor", "sfinder.header",
       "engine.prepare", "detect", "edge_flagging", "stitch", "save"}
# the spans of SFinder.run_tiled on the CPU's full path
RUN_SPANS = {"sfinder.header", "engine.prepare", "detect", "sfinder.read",
             "engine.stage", "engine.dispatch", "engine.origins",
             "sfinder.drain", "sfinder.drain_wait", "edge_flagging",
             "stitch", "save"}
# the children of cli.load_weights and cli.build on the npz route
WEIGHTS_SPANS = {"weights.read": "cli.load_weights",
                 "weights.upload": "cli.build", "weights.fold": "cli.build"}
NAMES = TOP | RUN_SPANS | set(WEIGHTS_SPANS) | {"engine.pin",
                                                 "preprocess_mosaic"}


@pytest.fixture(scope="module")
def mosaic(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "field.fits")
    write_mosaic_fits(path, N, N, n_sources=12, seed=3)
    return path


def run_cli(mosaic, out, *extra):
    """cli.run on the mosaic, outputs under `out` -> (sf, wall)."""
    os.makedirs(out, exist_ok=True)
    argv = [f"--image={mosaic}", f"--weights={WEIGHTS}", *FLAGS,
            f"--detect_outfile_json={out}/c.json",
            f"--detect_outfile={out}/c.reg",
            f"--spool_path={out}/spool.jsonl", *extra]
    t0 = time.perf_counter()
    rc, sf = cli_run.run(argv)
    wall = time.perf_counter() - t0
    assert rc == 0 and sf.report.n_tiles == 9
    return sf, wall


@pytest.fixture(scope="module")
def tiled(mosaic, tmp_path_factory):
    return run_cli(mosaic, str(tmp_path_factory.mktemp("run")))


def named(spans, name):
    return [s for s in spans if s.name == name]


def test_each_batch_has_one_dispatch_and_one_drain_under_its_index(tiled):
    spans = tiled[0].report.spans
    dispatch, drain = named(spans, "engine.dispatch"), named(spans,
                                                             "sfinder.drain")
    assert sorted(s.batch for s in dispatch) == list(range(4))
    assert sorted(s.batch for s in drain) == list(range(4))
    for s in dispatch + drain:
        assert spans[s.parent].name == "detect"
    for child, parent in (("engine.origins", dispatch),
                          ("sfinder.drain_wait", drain)):
        kids = named(spans, child)
        assert len(kids) == 4
        for s in kids:
            assert spans[s.parent] in parent
            assert spans[s.parent].start <= s.start <= s.end <= spans[
                s.parent].end
    # the drain's wait carries its batch too
    assert all(s.batch == spans[s.parent].batch
               for s in named(spans, "sfinder.drain_wait"))


def test_top_level_spans_are_disjoint_and_inside_the_wall(tiled):
    sf, wall = tiled
    main = threading.get_ident()
    top = sorted((s for s in sf.report.spans
                  if s.parent is None and s.thread == main),
                 key=lambda s: s.start)
    assert {s.name for s in top} == TOP
    for a, b in zip(top, top[1:]):
        assert a.end <= b.start, (a, b)
    assert 0 < sum(s.end - s.start for s in top) <= wall
    assert {s.name for s in sf.report.spans} <= NAMES


def test_the_weights_spans_nest_in_the_set_up_spans(tiled):
    """On the npz route the weights' read is inside cli.load_weights, the
    upload and the fold (BatchNorm's statistics before the upload, the
    kernels after it) inside cli.build."""
    spans = tiled[0].report.spans
    for child, parent in WEIGHTS_SPANS.items():
        inner = named(spans, child)
        assert len(inner) == (2 if child == "weights.fold" else 1)
        for s in inner:
            outer = spans[s.parent]
            assert outer.name == parent
            assert outer.start <= s.start <= s.end <= outer.end
    fold, upload = named(spans, "weights.fold"), named(spans, "weights.upload")
    assert fold[0].end <= upload[0].start <= upload[0].end <= fold[1].start
    phase = tiled[0].report.phase_times
    assert all(phase[k] > 0 for k in TOP)


@pytest.mark.parametrize("context", ["tile", "global"])
def test_the_old_phase_keys_and_read_s_stay(mosaic, tmp_path, context):
    sf, _ = run_cli(mosaic, str(tmp_path), f"--preproc_context={context}")
    rep = sf.report
    for key in ("detect", "edge_flagging", "stitch", "save"):
        assert rep.phase_times[key] > 0, key
    assert ("preprocess_mosaic" in rep.phase_times) == (context == "global")
    assert rep.read_s == rep.phase_times["sfinder.read"] > 0
    assert rep.phase_times == pytest.approx(sf.recorder.totals())


@pytest.mark.parametrize("path,extra", [
    ("band", dict(device_tiling_max_bytes=N * 96 * 4)),
    ("stream", dict(device_tiling="off"))])
def test_worker_spans_are_summed_into_the_run(mosaic, tmp_path, path, extra):
    model, _ = load_model(WEIGHTS)
    cfg = SFinderConfig(image_path=mosaic, img_size=96, score_thr=0.3,
                        split_image_in_tiles=True, tile_xsize=96,
                        tile_ysize=96, tile_xstep=0.75, tile_ystep=0.75,
                        batch_size=4, outfile_json=str(tmp_path / "c.json"),
                        outfile_ds9=str(tmp_path / "c.reg"),
                        spool_path=str(tmp_path / "spool.jsonl"), **extra)
    sf = SFinder(model, cfg, preprocessor=build_preprocessor(
        normalize_minmax=True), engine_kwargs={"compute_dtype":
                                               torch.float32},
                 device="cpu")
    assert sf.run_tiled() == 0 and sf.report.tiling_mode == path
    rep, main = sf.report, threading.get_ident()
    for name in ("sfinder.read", "engine.stage"):
        spans = named(rep.spans, name)
        assert spans and all(s.thread != main for s in spans), name
        assert rep.phase_times[name] == pytest.approx(
            sum(s.end - s.start for s in spans))
    assert rep.read_s == rep.phase_times["sfinder.read"]
    assert sorted(s.batch for s in named(rep.spans, "engine.dispatch")) == \
        sorted(s.batch for s in named(rep.spans, "sfinder.drain")) == \
        list(range(len(named(rep.spans, "sfinder.drain"))))


def test_no_range_under_a_session_the_program_did_not_open(mosaic,
                                                            tmp_path):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sf, _ = run_cli(mosaic, str(tmp_path))
    assert "engine.dispatch" in sf.report.phase_times
    seen = {e.name for e in prof.events()}
    assert any("conv" in n for n in seen)
    assert not seen & NAMES


def test_profile_dir_trace_holds_the_spans(mosaic, tmp_path):
    prof = tmp_path / "prof"
    run_cli(mosaic, str(tmp_path), f"--profile_dir={prof}")
    events = json.loads((prof / "field.trace.json").read_text())[
        "traceEvents"]
    seen = {e.get("name") for e in events}
    assert RUN_SPANS <= seen, RUN_SPANS - seen
    assert any("conv" in str(n) for n in seen)


def test_device_starved_is_absent_on_the_cpu(tiled):
    assert trace.DEVICE_STARVED not in tiled[0].report.phase_times


class FakeEvent:
    """A timing event on a virtual device clock (seconds)."""
    clock = 0.0

    def __init__(self, enable_timing):
        assert enable_timing

    def record(self, stream):
        self.t = FakeEvent.clock

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_starved_adds_the_gaps_between_consecutive_batches(monkeypatch):
    """Batches of 2 s with gaps of 1, 3 and 0.5 s before them: the first
    gap precedes the field's first batch and is not counted."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(FakeEvent, "clock", 0.0)
    rec, dev = trace.Recorder(), torch.device("cuda")
    for k, gap in enumerate((1.0, 3.0, 0.5)):
        FakeEvent.clock += gap
        with rec.on_device(k, dev):
            FakeEvent.clock += 2.0
    assert rec.totals() == {trace.DEVICE_STARVED: 0.0}
    for k in range(3):
        rec.batch_done(k)
    assert rec.totals()[trace.DEVICE_STARVED] == pytest.approx(3.5)
    assert list(rec._events) == [2]     # only the last batch's events left
    with rec.on_device(None, dev), rec.on_device(3, torch.device("cpu")):
        pass
    assert list(rec._events) == [2]


def test_the_null_recorder_records_nothing():
    with trace.NULL.span("x", 0), trace.NULL.on_device(0, torch.device(
            "cuda")):
        trace.NULL.add("y", 1.0)
        trace.NULL.batch_done(0)
    assert trace.NULL.spans == [] and trace.NULL.totals() == {}


def test_recorder_keeps_every_span_and_count_across_threads():
    """More threads than cores, a short switch interval: no span or count
    is lost, and each thread's spans nest under its own."""
    rec, n_threads, n = trace.Recorder(), 4 * (os.cpu_count() or 1), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(n):
            with rec.span("outer"):
                with rec.span("inner"):
                    rec.add("count", 1.0)

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(rec.spans) == 2 * n * n_threads
    assert rec.counters["count"] == n * n_threads
    for s in rec.spans:
        if s.name == "inner":
            p = rec.spans[s.parent]
            assert p.name == "outer" and p.thread == s.thread
        else:
            assert s.parent is None


def test_the_trainer_spans_its_gradient_all_reduce(tmp_path):
    """Under a process group (one gloo rank here), the multi-process
    worker's bf16 profile gives its trainer a recorder and reads the
    `train.grad_all_reduce` span's host time from it, inside the profiled
    step's wall."""
    import torch.distributed as dist

    import test_torch_train_golden as golden_train
    import torch_mp_worker

    model, _ = load_model(WEIGHTS)
    batch = torch_mp_worker.train_batch({"batch": (2, 64)})
    cfg = dict(golden_train.CONFIG, batch_size=2, img_size=64,
               compute_dtype="float32")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        out = torch_mp_worker.bf16_step(model, cfg, batch, "cpu")
    finally:
        dist.destroy_process_group()
    assert 0 < out["profiled_span_s"] < out["profiled_step_s"]
