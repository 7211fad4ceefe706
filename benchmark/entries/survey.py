"""Survey fields through `caesar_yolo_tpu_torch.cli.run`, one call a field.

A survey pipeline calls the CLI once per field: each call reads the FITS
field, loads the weights, builds the engine, detects on every tile, flags
edges, stitches and writes the catalog.  The window runs fields back to
back and finishes the field in progress when `--seconds` runs out.

Workload parameters (workloads/<cell>.json):
  field         the traffic (traffic/mosaic.py: field_px, n_sources, ...)
  flags         cli.run's flags after --image and --weights
  calib_tiles   tiles the weights are calibrated on (reference/weights.py)
  warm_fields   fields run before the window (cuDNN's choices, allocator)
  trace_units   fields the traced run's profiler session covers
  limits        {"catalog_miss": limit} (reference/compare.py)

Units: one field each, with its wall and the program's SFinderReport.
Check: every distinct catalog the window wrote against the reference's
catalog of the field (reference/survey.py), by `catalog_miss`.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import time
from collections import Counter

import numpy as np
import torch

from harness.core import log, substream
from reference import compare, survey
from reference.model import YOLO, exact_f32, load_npz
from reference.weights import calibrate, draw, save_npz
from traffic import mosaic

# kernels named by the survey metrics, each with the program's counter
KERNEL_COUNTERS = {
    "epilogue_kernel":
        "caesar_yolo_tpu_torch.models.cuda_epilogue:conv_epilogue.launches",
    "zscale_cluster_kernel":
        "caesar_yolo_tpu_torch.ops.cuda_preproc:"
        "zscale_minmax.cluster_launches",
    "clip_stats_cluster_kernel":
        "caesar_yolo_tpu_torch.ops.cuda_stats:clip_stats.launches",
}


def field_of(ctx):
    """The field's pixels with NaN as 0, as the program's reader gives
    them."""
    return np.nan_to_num(ctx.image, nan=0.0)


def make_weights(ctx, path):
    """Draw the configuration's weights from the seed on the device, and
    calibrate them on `calib_tiles` tiles spread over the field (partial
    tiles at its far edges among them) as the run's chain and letterbox
    prepare them; write the npz."""
    cfg, p = ctx.cell.config, ctx.cell.params
    dev = ctx.device
    a = survey.parse_flags(p["flags"])
    windows = survey.tile_grid(*ctx.image.shape, a)
    picks = windows[::len(windows) // p["calib_tiles"] + 1]
    img = field_of(ctx)
    with exact_f32():
        model = YOLO(cfg["model"], cfg["nc"]).to(dev)
        draw(model, substream(ctx.seed, 1), cfg["init"], dev)
        x = torch.cat([survey.letterbox(survey.preprocess(
            torch.from_numpy(img[y0:y1, x0:x1])[None].to(dev), a)[0],
            a.imgsize) for x0, x1, y0, y1 in picks])
        calibrate(model, x, cfg["init"], a.scoreThr)
    save_npz(model, path, {"model": cfg["model"], "num_classes": cfg["nc"]})


def setup(ctx):
    p = ctx.cell.params
    a = survey.parse_flags(p["flags"])
    ctx.batch_size = a.batch_size
    shapes = Counter((y1 - y0, x1 - x0) for x0, x1, y0, y1 in
                     survey.tile_grid(p["field"]["field_px"],
                                      p["field"]["field_px"], a))
    # the device batches of a field, one (h, w) each (padded to batch_size)
    ctx.batches = [hw for hw, n in shapes.items()
                   for _ in range(-(-n // a.batch_size))]
    with ctx.spans("setup.traffic"):
        ctx.image = mosaic.make_field(
            np.random.default_rng(substream(ctx.seed, 0)), **p["field"])
        ctx.fits = os.path.join(ctx.tmp, "field.fits")
        mosaic.write_fits(ctx.image, ctx.fits)
    with ctx.spans("setup.weights"):
        ctx.weights = os.path.join(ctx.tmp, "weights.npz")
        make_weights(ctx, ctx.weights)
    with ctx.spans("setup.import"):
        from caesar_yolo_tpu_torch.cli import run as cli_run
        ctx.cli_run = cli_run
    ctx.argv = [f"--image={ctx.fits}", f"--weights={ctx.weights}",
                *p["flags"], *(["--int8"] if ctx.variant == "int8" else []),
                *([f"--devices={ctx.device}"] if ctx.device != "cuda"
                  else [])]
    os.chdir(ctx.tmp)
    if ctx.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with ctx.spans("setup.warm"):
        for k in range(p["warm_fields"]):
            run_field(ctx, f"warm{k}")


def run_field(ctx, tag):
    argv = ctx.argv + [f"--detect_outfile_json=catalog_{tag}.json",
                       f"--detect_outfile=ds9_{tag}.reg"]
    t0 = time.perf_counter()
    with ctx.spans("field"):
        rc, sf = ctx.cli_run.run(argv)
    wall = time.perf_counter() - t0
    rep = sf.report if sf is not None else None
    unit = {"tag": tag, "wall": wall, "rc": rc,
            "catalog": f"catalog_{tag}.json",
            "tiles": rep.n_tiles if rep else 0,
            "read_s": rep.read_s if rep else 0.0,
            "phase": dict(rep.phase_times) if rep else {}}
    return unit


def window(ctx, seconds, tracer):
    tracer.begin()
    t0 = ctx.window_t0 = time.perf_counter()
    k = 0
    while True:
        ctx.units.append(run_field(ctx, str(k)))
        k += 1
        tracer.after_unit()
        if time.perf_counter() - t0 - tracer.overhead_s >= seconds:
            break
    # the profiler's stop (the traced run only) is not the program's time
    ctx.window_s = time.perf_counter() - t0 - tracer.overhead_s


def kernel_checks(ctx):
    return dict(KERNEL_COUNTERS)


def memory_peak(ctx):
    if ctx.device != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(d)
               for d in range(ctx.cell.chips))


def attempted(ctx):
    return len(ctx.units), sum(u["rc"] != 0 for u in ctx.units)


def end_to_end(ctx):
    for u in ctx.units:
        log(f"field {u['tag']}: wall {u['wall']:.3f} s, read "
            f"{u['read_s']:.3f} s, " + ", ".join(
                f"{k} {v:.3f}" for k, v in u["phase"].items()))
    tiles = sum(u["tiles"] for u in ctx.units if u["rc"] == 0)
    return {"survey_tiles_per_s": tiles / ctx.window_s}


def release(ctx):
    ctx.cli_run = None
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()


def reference_catalog(ctx):
    cfg = ctx.cell.config
    with exact_f32():
        model = load_npz(YOLO(cfg["model"], cfg["nc"]), ctx.weights)
        model = model.to(ctx.device).eval()
        return survey.catalog(model, field_of(ctx), ctx.cell.params["flags"],
                              ctx.device)


def check(ctx):
    """[(name, value, limit)]: the worst field's catalog miss, and the
    fields that wrote no catalog."""
    a = survey.parse_flags(ctx.cell.params["flags"])
    ref = reference_catalog(ctx)
    seen, worst, missing = {}, 0.0, 0
    for u in ctx.units:
        path = os.path.join(ctx.tmp, u["catalog"])
        if u["rc"] != 0 or not os.path.exists(path):
            missing += 1
            continue
        with open(path, "rb") as f:
            raw = f.read()
        key = hashlib.sha256(raw).hexdigest()
        if key not in seen:
            ours = json.loads(raw)["sources"]
            seen[key], details = compare.catalog_miss(ours, ref, a.scoreThr)
            log(f"catalog {u['tag']}: miss {seen[key]!r} {details}")
        worst = max(worst, seen[key])
    return [("catalog_miss", worst, ctx.cell.params["limits"]["catalog_miss"]),
            ("fields_without_catalog", missing, 0)]
