#!/usr/bin/env python3
"""Configurations of the cluster-per-plane K5 (csrc/stats.cu), the
two-launch K1 (csrc/nms.cu), the cluster-per-plane K6 (csrc/histeq.cu),
K8's two routes (csrc/shift.cu), K3's persistent clusters
(csrc/preproc.cu), K4's backward (csrc/upsample.cu) and the
cluster-per-plane K7 (csrc/clahe.cu) on one CUDA card.

Prints the card's name and power limit, each kernel's registers, shared
memory and spills (`nvcc -Xptxas -v`), then:
  - K5 at the paths' shapes ([32,512,512] mosaic tiles, [32,256,512]
    truncated tiles, [1,640,640] the serial crop, [32,132,132] eval
    cutouts, [2,2048,2048] the stream route) for clusters of up to 8 or
    16 blocks and blocks of 512 or 1024 threads (and, for batches of
    planes up to 512x512, the stream route, the planes re-read from L2
    on every pass): agreement with the
    plain version (cuda_stats.stats_mismatch), the time by CUDA events
    and the device time under torch.profiler;
  - K1 at [32,4,512] and [32,4,2048]: bit-equality with the plain
    version, the wrapper's time by CUDA events, the device time of each
    of its two launches;
  - K6 at [32,512,512] (chip_smoke.py's mosaic planes), [1,640,640] and
    [32,132,132] for clusters of up to 4, 8 or 16 blocks of 512 or 1024
    threads, and the stream route: bit-equality, CUDA events, device
    time;
  - K8 at [16,1092,1092,3], pad 548, on the augmentation's shears: the
    row route (the x-shear), the y-shear as a transposed copy plus a row
    launch, and the column route on the transposed view for strips of
    X columns and bands of Y rows: bit-equality, CUDA events, device
    time;
  - K3 at [32,640,640] (the main path) and [32,132,132] (the eval path)
    for clusters of 4, 8 or 16 blocks with a block's part copied in 1, 2,
    4 or 8 bulk copies, and the stream route: bit-equality, CUDA events,
    device time;
  - K4's backward at yolo11l@640's training gradients [16,512,80,80] and
    [16,512,40,40] bf16, as the concat's channel slice and contiguous, at
    each vector width of 16, 8, 4 and 2 bytes: bit-equality, CUDA events,
    device time;
  - K7 at [32,132,132] (the eval path) and [32,640,640] (the tile size)
    for clusters of 1 to 16 blocks (where a block's shared memory fits),
    and the stream route: bit-equality with the plain version, the whole
    call by CUDA events, device time.

Run from the repository root:
    python3 scripts/torch_kernel_tune.py \
        [--only stats,nms,histeq,shift,preproc,upsample_bwd,clahe]
"""

from __future__ import annotations

import argparse
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

K5_SHAPES = ((32, 512, 512), (32, 256, 512), (1, 640, 640), (32, 132, 132),
             (2, 2048, 2048))


def ptxas(name):
    from caesar_yolo_tpu_torch import cuda_build
    out = os.path.join(cuda_build.BUILD_DIR, f"ptxas_{name}.so")
    cmd = cuda_build._command(name, out)
    cmd.insert(1, "-Xptxas=-v")
    log = subprocess.run(cmd, capture_output=True, text=True).stderr
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def tune_histeq(torch, cs, dev, rng) -> int:
    """K6's configurations; returns the number that differ from the plain
    version."""
    import numpy as np

    from caesar_yolo_tpu_torch.ops import cuda_histeq
    from caesar_yolo_tpu_torch.ops.histeq import equalize_hist
    failed = 0
    for shape in ((32, 512, 512), (1, 640, 640), (32, 132, 132)):
        x = (cs.mosaic_planes(dev, rng) if shape == (32, 512, 512) else
             torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
             .to(dev))
        ref = equalize_hist(x).nan_to_num()
        hw = shape[1] * shape[2]
        configs = [(*cuda_histeq.plan(hw, mc)[:2], t)
                   for mc in (4, 8, 16) for t in (512, 1024)]
        configs = [c for c in dict.fromkeys(configs) if c[0] == "cluster"]
        for route, cluster, threads in configs + [
                ("stream", 16, cuda_histeq.STREAM_THREADS)]:
            call = lambda: cuda_histeq.launch(x, route, cluster, threads)
            try:
                ok = torch.equal(call().nan_to_num(), ref)
            except RuntimeError as err:     # a refused cluster
                print(f"K6 {list(shape)} {route} cluster {cluster} threads "
                      f"{threads}: {err}", flush=True)
                continue
            failed += not ok
            ms = cs.time_ms(torch, call)
            dms = cs.device_ms(torch, call)
            print(f"K6 {list(shape)} {route} cluster {cluster} threads "
                  f"{threads}: {ms:.5f} ms (device {dms:.5f}) bit-equal "
                  f"{ok}", flush=True)
    return failed


def tune_clahe(torch, cs, dev) -> int:
    """K7's configurations; returns the number that differ from the plain
    version."""
    from caesar_yolo_tpu_torch.ops import clahe, cuda_clahe
    failed = 0
    for shape in ((32, 132, 132), (32, 640, 640)):
        x = cs.clahe_planes(dev, *shape, seed=2, edge_cases=False)
        ref = clahe.equalize_adapthist_plain(x, 0.03)
        configs = []
        for cluster in (1, 2, 4, 8, 16):
            rows, win, smem = cuda_clahe.layout(*shape[1:], cluster)
            if smem <= cuda_clahe.SMEM_BYTES:
                configs.append(("cluster", cluster, rows, win))
        for config in configs + [("stream", 0, 0, 0)]:
            call = lambda: cuda_clahe.launch(x, 0.03, clahe.GRID, *config)
            try:
                ok = torch.equal(call(), ref)
            except RuntimeError as err:     # a refused cluster
                print(f"K7 {list(shape)} {config}: {err}", flush=True)
                continue
            failed += not ok
            ms = cs.time_ms(torch, call)
            dms = cs.device_ms(torch, call)
            mark = " (plan)" if config == cuda_clahe.plan(*shape[1:]) else ""
            print(f"K7 {list(shape)} {config[0]} cluster {config[1]}{mark}: "
                  f"{ms:.5f} ms (device {dms:.5f}) bit-equal {ok}",
                  flush=True)
    return failed


def tune_shift(torch, cs, dev) -> int:
    """K8's routes and the column route's tiles; returns the number of
    configurations that differ from the plain version."""
    from caesar_yolo_tpu_torch.ops import cuda_shift
    b, hp, pad, pad_val = cs.TRAIN_BATCH, cs.SHIFT_CANVAS, cs.SHIFT_PAD, 0.45
    g = torch.Generator(device=dev).manual_seed(0)
    canvas = torch.rand(b, hp, hp, 3, device=dev, generator=g)
    r = (torch.rand(b, device=dev, generator=g) * 2 - 1) * (math.pi / 4)
    ys = torch.arange(hp, dtype=torch.float32, device=dev) - (hp - 1) / 2
    shifts = torch.tan(r)[:, None] * ys[None]
    k0, f = (t.contiguous() for t in cuda_shift._split_shifts(shifts, pad))
    view = canvas.transpose(1, 2)
    ref = cuda_shift.row_shift_plain(view, shifts, pad, pad_val)
    failed = 0

    def report(name, call, want):
        nonlocal failed
        ok = torch.equal(call(), want)
        failed += not ok
        print(f"K8 {name}: {cs.time_ms(torch, call):.5f} ms (device "
              f"{cs.device_ms(torch, call):.5f}) bit-equal {ok}", flush=True)

    report("row route (x-shear on the canvas)",
           lambda: cuda_shift.launch(canvas, k0, f, pad_val, "row"),
           cuda_shift.row_shift_plain(canvas, shifts, pad, pad_val))
    report("y-shear, transposed copy + row route",
           lambda: cuda_shift.launch(view.contiguous(), k0, f, pad_val,
                                     "row"), ref)
    for xw in (8, 16, 32, 64):
        for yh in (16, 32, 64, 128):
            for threads in (256, 512):
                report(f"y-shear, column route X {xw} Y {yh} threads "
                       f"{cuda_shift.col_threads(3, xw, threads)}",
                       lambda: cuda_shift.launch(view, k0, f, pad_val,
                                                 "column", xw, yh, threads),
                       ref)
    return failed


def tune_preproc(torch, cs, dev, rng) -> int:
    """K3's cluster sizes and segments, and its stream route; returns the
    number of configurations that differ from the plain version."""
    from caesar_yolo_tpu_torch.ops import cuda_preproc
    from caesar_yolo_tpu_torch.ops.zscale import zscale_limits
    failed = 0
    for shape in ((32, 640, 640), (32, 132, 132)):
        x = cs.preproc_planes(dev, rng, shape)
        vlims = torch.stack(zscale_limits(x), dim=1)
        ref = cuda_preproc.zscale_minmax_plain(x, vlims)
        for route, cluster, segs in [
                ("cluster", c, ns) for c in (4, 8, 16)
                for ns in (1, 2, 4, 8)] + [("stream", 16, 0)]:
            call = lambda: cuda_preproc.launch(x, vlims, 0.0, 1.0, route,
                                               cluster, segs)
            what = (f"K3 {list(shape)} {route} cluster {cluster} segments "
                    f"{segs}")
            try:
                got = call()
                torch.cuda.synchronize()
            except RuntimeError as err:     # does not fit, or refused
                print(f"{what}: {err}", flush=True)
                continue
            ok = all(torch.equal(a, b) for a, b in zip(got, ref))
            failed += not ok
            print(f"{what}: {cs.time_ms(torch, call):.5f} ms (device "
                  f"{cs.device_ms(torch, call):.5f}) bit-equal {ok}",
                  flush=True)
    return failed


def tune_upsample_bwd(torch, cs, dev) -> int:
    """K4's backward at each vector width, on the concat's channel slice
    and on a contiguous gradient; returns the number of widths that differ
    from the plain version."""
    from caesar_yolo_tpu_torch.ops import cuda_upsample
    g_ = torch.Generator(device=dev).manual_seed(0)
    failed = 0
    for b, c, h2, w2 in ((16, 512, 80, 80), (16, 512, 40, 40)):
        full = torch.randn(b, 2 * c, h2, w2, device=dev, generator=g_).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        for name, g in (("slice", full[:, :c]), ("contiguous", full[:, :c]
                        .contiguous(memory_format=torch.channels_last))):
            ref = cuda_upsample.upsample2x_backward_plain(g)
            for vb in (16, 8, 4, 2):
                call = lambda: cuda_upsample.launch_backward(g, vb)
                ok = torch.equal(call(), ref)
                failed += not ok
                print(f"K4-bwd {[b, c, h2, w2]} {name} {vb}-byte vectors: "
                      f"{cs.time_ms(torch, call):.5f} ms (device "
                      f"{cs.device_ms(torch, call):.5f}) bit-equal {ok}",
                      flush=True)
    return failed


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from caesar_yolo_tpu_torch import cuda_build
    from caesar_yolo_tpu_torch.detect import cuda_nms, nms
    from caesar_yolo_tpu_torch.ops import cuda_stats
    from caesar_yolo_tpu_torch.ops.stats import clip_stats_plain

    parser = argparse.ArgumentParser()
    parser.add_argument("--only",
                        default="stats,nms,histeq,shift,preproc,upsample_bwd,"
                        "clahe", help="comma-separated kernels to tune")
    kernels = parser.parse_args().only.split(",")
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    sources = sorted({"upsample_bwd": "upsample"}.get(k, k) for k in kernels)
    cuda_build.build(sources)
    for name in sources:
        for ln in ptxas(name):
            print(f"ptxas {name}: {ln}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    failed = 0
    if "histeq" in kernels:
        failed += tune_histeq(torch, cs, dev, rng)
    if "shift" in kernels:
        failed += tune_shift(torch, cs, dev)
    if "preproc" in kernels:
        failed += tune_preproc(torch, cs, dev, rng)
    if "upsample_bwd" in kernels:
        failed += tune_upsample_bwd(torch, cs, dev)
    if "clahe" in kernels:
        failed += tune_clahe(torch, cs, dev)
    sig = cs.MOSAIC_SIGMAS[0]
    for shape in K5_SHAPES if "stats" in kernels else ():
        if shape == (32, 512, 512):
            x = cs.mosaic_planes(dev, rng)
        else:
            x = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)
                                 ).to(dev)
            x[:, :2] = 0.0
        ref = clip_stats_plain(x, None, *sig)
        hw = shape[1] * shape[2]
        configs = [(*cuda_stats.plan(hw, mc)[:2], t) for mc in (8, 16)
                   for t in (512, 1024)]
        if shape[0] > 1 and hw <= 512 * 512:   # planes re-read from L2
            configs += [("stream", mc, 512) for mc in (8, 16)]
        for route, cluster, threads in configs:
            call = (lambda: cuda_stats.launch(x, *sig, 5, route, cluster,
                                              threads))
            got = call()
            torch.cuda.synchronize()
            why = cuda_stats.stats_mismatch(got, ref)
            failed += why is not None
            ms = cs.time_ms(torch, call, iters=10)
            dms = cs.device_ms(torch, call, iters=10)
            print(f"K5 {list(shape)} {route} cluster {cluster} threads "
                  f"{threads}: {ms:.5f} ms (device {dms:.5f}) -> "
                  f"{why or 'ok'}", flush=True)

    for k in (512, 2048) if "nms" in kernels else ():
        boxes, scores = cs.synthetic_detections(
            rng, cs.MAIN_BATCH, sum((640 // s) ** 2 for s in (8, 16, 32)),
            640.0, tied=False)
        sel = nms._select_candidates(torch.from_numpy(boxes).to(dev),
                                     torch.from_numpy(scores).to(dev), 0.25,
                                     k, False)
        boxes_t = sel[5].transpose(1, 2).contiguous()
        valid = sel[3].contiguous()
        call = lambda: cuda_nms.nms_suppress(boxes_t, valid, 0.5)
        got = call()
        torch.cuda.synchronize()
        ok = torch.equal(got, cuda_nms.suppress_plain(
            boxes_t.transpose(1, 2), valid, 0.5))
        failed += not ok
        split = cs.kernel_split(torch, call)
        print(f"K1 [32,4,{k}]: {cs.time_ms(torch, call):.5f} ms (device "
              f"{split}) bit-equal {ok}", flush=True)
    print("FAIL" if failed else "OK")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
