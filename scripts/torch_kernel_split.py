#!/usr/bin/env python3
"""Split the time of K5 (csrc/stats.cu), K1 (csrc/nms.cu), K6
(csrc/histeq.cu), K8 (csrc/shift.cu), K3 (csrc/preproc.cu), K4's
backward (csrc/upsample.cu) and K7 (csrc/clahe.cu) on one CUDA card, for
either
design of K5 and K1: the one-block-per-plane K5 and one-block-per-image
K1 up to commit 0a0e8d7, or the cluster-per-plane K5 and the two-launch
K1 after it (told apart by their sources).

For each kernel, at the mosaic path's shapes (K5 at [32, 512, 512] on
chip_smoke.py's mosaic planes and at the serial crop's [1, 640, 640];
K1 at [32, 4, 512] on chip_smoke.py's random candidates):
  - the time of the C entry point called directly (CUDA events) and its
    device time under torch.profiler;
  - for K1 also the Python wrapper `cuda_nms.nms_suppress` by CUDA events
    (what chip_smoke.py times), so the difference is host work;
  - the share of each phase in the kernel's clock64 cycles (thread 0's
    view, summed over blocks), from a scratch build of the same source
    with clock64 reads inserted at fixed lines; the shares times the
    device time give the phase split in ms.  Old K5: min/max, moments,
    bisection, pin; old K1: load, mask build, scan.  New K5, over all
    passes: the sweep, the wait at the block barrier, the block's
    combine, the cluster barrier, the combine over the cluster, the walk
    and the next trees (thread 0), the closing barrier, the copy into
    shared memory.  New K1: each launch's device time under the profiler,
    and the scan launch's steps (copying the mask rows into shared
    memory, the 32 decisions of each step, the keep flags and the kept
    rows' words).

K6, K8, K3, K4's backward and K7 are timed through the checkout's own
wrappers (run the script of another checkout to split its design):
  - K6 at [32, 512, 512] (chip_smoke.py's mosaic planes) and at the serial
    crop's [1, 640, 640]: the wrapper's time by CUDA events, the device
    time of each of its launches under torch.profiler, and the bound;
  - K8 at the training canvas [16, 1092, 1092, 3], pad 548, on shears
    drawn as augment.py draws them (residual angles uniform in +-45
    degrees): the x-shear on the contiguous canvas and the y-shear on its
    transposed view (whatever the wrapper does with that view: a copy
    and a row launch, or a launch that reads the view), each by CUDA
    events and by device time per launch, with the bytes a second the
    device time gives for the bound's bytes;
  - K3 at the main path's [32, 640, 640] and the eval path's
    [32, 132, 132] (chip_smoke.py's K3 planes): CUDA events, the host
    time of a call (the wrapper's, and the C entry point's alone), device
    time per launch and the bound, beside the wrapper's zscale_limits; for
    the
    cluster route (told apart by its source) the clock64 phases of a
    scratch build: waiting for each segment's copy, the stretch, the
    reduce and push, the cluster barrier, the combine, the normalise and
    write, the block barrier and the next plane's copy, the start;
  - K4's backward at yolo11l@640's training gradients [16, 512, 80, 80]
    and [16, 512, 40, 40] bf16, on a contiguous gradient and on the
    concat's channel slice (whatever the wrapper does with it: a copy and
    a launch, or a launch that reads it in place), by events, host time
    and device time, with the channels_last copy of the slice timed
    alone;
  - K7 at the eval path's [32, 132, 132] and the tile size's
    [32, 640, 640] (chip_smoke.py's CLAHE planes): the whole
    equalize_adapthist_batch call by CUDA events, its host time, device
    time per launch and the bound; for the cluster route (told apart by
    its source) the clock64 phases of a scratch build, over the planes a
    block walks: the start and the wait for each copy, min/max and its
    push, the first cluster barrier and the combine, binning and
    counting, the counts' push, the second cluster barrier, the next copy
    and the tables, the blend and write; and the clusters resident at
    once (the blocks that ran, over the cluster size).

Run from the repository root (default: the checkout's own csrc/ and all
six kernels), or pointing at the csrc/ of another checkout (e.g. the
parent unpacked with `git archive` into build/):
    python3 scripts/torch_kernel_split.py \
        [--csrc <dir>/caesar_yolo_tpu_torch/csrc] [--only preproc,clahe]
Writes its results also to build/kernel_split.json.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NPH = 8                   # phase slots a block
CLK = ("#define CLK(i) { long long _u = clock64(); "
       "if (threadIdx.x == 0) g_clk[blockIdx.x * 8 + (i)] += _u - _t; "
       "_t = _u; }\n")
READER = """
__device__ long long g_clk[8 * 8192];
__device__ long long g_last[8192];
"""
# the new K5's phases cross functions: thread 0 keeps its last reading in
# device memory
CLK_NEW = """#define BLK (blockIdx.y * gridDim.x + blockIdx.x)
#define CLKSET { if (threadIdx.x == 0) g_last[BLK] = clock64(); }
#define CLK(i) { if (threadIdx.x == 0) { long long _u = clock64(); \\
  g_clk[BLK * 8 + (i)] += _u - g_last[BLK]; g_last[BLK] = _u; } }
"""
EXPORT = """
extern "C" int cy_split_clocks(long long* out, int n, int reset) {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_clk);
  if (e != cudaSuccess) return (int)e;
  if (reset) return (int)cudaMemset(p, 0, sizeof(long long) * 8 * 8192);
  return (int)cudaMemcpy(out, p, sizeof(long long) * n,
                         cudaMemcpyDeviceToHost);
}
"""

# (anchor, text inserted after it); every anchor must occur once
STATS_PATCH = [
    ("namespace {\n", READER + CLK),
    ("                          Reductions& red) {\n",
     "  long long _t = clock64();\n"),
    ("  block_reduce<2>(mom, sums, red.f);\n", "  CLK(1)\n"),
    ("    if (c[1] >= k2) hi2 = mid2; else lo2 = mid2;\n  }\n", "  CLK(2)\n"),
    ("  const float r2 = c1[1] >= k2 ? m1[1] : "
     "(isfinite(m2[1]) ? m2[1] : hi2);\n",
     "  CLK(3)\n"),
    ("  __shared__ Reductions red;\n", "  long long _t = clock64();\n"),
    ("  block_reduce<2>(mm, minmax, red.f);\n", "  CLK(0)\n"),
]
NMS_PATCH = [
    ("namespace {\n", READER + CLK),
    ("  extern __shared__ __align__(16) unsigned char smem[];\n",
     "  long long _t = clock64();\n"),
    ("  for (int w = threadIdx.x; w < words; w += blockDim.x) "
     "removed[w] = 0u;\n"
     "  __syncthreads();\n", "  CLK(0)\n"),
    ("    mask[t] = bits;\n  }\n  __syncthreads();\n", "  CLK(1)\n"),
    ("      __syncwarp();\n    }\n", "    CLK(2)\n"),
]
STATS_PATCH_NEW = [
    ("namespace {\n", READER + CLK_NEW),
    ("  cg::cluster_group cl = cg::this_cluster();\n", "  CLKSET\n"),
    ("  int parity = 0;\n", "  CLK(7)\n", True),
    ("  __syncthreads();\n  Slot* gather = sm.gather[parity];\n",
     "  CLK(0)\n", True),
    ("  Slot* gather = sm.gather[parity];\n", "  CLK(1)\n", True),
    ("  cl.sync();\n  if (warp == 0) {\n    if (pin) {", "  CLK(2)\n", True),
    ("  if (warp == 0) {\n    if (pin) {\n      if (lane < 2) {\n"
     "        Pin acc{gather[0]", "  CLK(3)\n", True),
    ("    if (lane == 0) post(sm.st, sm.res);\n", "    CLK(4)\n", True),
    ("    if (lane == 0) post(sm.st, sm.res);\n", "    CLK(5)\n"),
    ("  parity ^= 1;\n  __syncthreads();\n", "  CLK(6)\n"),
]
NMS_PATCH_NEW = [
    ("namespace {\n", READER + CLK_NEW),
    ("  const uint8_t* vsrc = valid + (size_t)img * k;\n"
     "  for (int i = threadIdx.x",
     "  CLKSET\n", True),
    ("    if (threadIdx.x >= 32) continue;\n", "    CLK(0)\n", True),
    ("      const uint32_t keep = vb & ~rw;\n", "      CLK(1)\n"),
    ("          if (w == lane + 32 * s) removed[s] |= v;\n      }\n",
     "      CLK(2)\n"),
]
HISTEQ_PATCH_NEW = [
    ("namespace {\n", READER + CLK_NEW),
    ("  cg::cluster_group cl = cg::this_cluster();\n", "  CLKSET\n"),
    ("  // min, max and the NaN flag over the cluster\n", "  CLK(0)\n", True),
    ("  cl.sync();\n  lo = INFINITY;\n", "  CLK(1)\n", True),
    ("  // the histogram: per-warp, then the block's into rank 0's\n",
     "  CLK(2)\n", True),
    ("[&](int, float v) { atomicAdd(&wh[bin_of(v, l)], 1); });\n"
     "  __syncthreads();\n", "  CLK(3)\n"),
    ("    if (t) atomicAdd(cl.map_shared_rank(sm.total, 0) + tid, t);\n  }\n",
     "  CLK(4)\n"),
    ("  // the CDF: an inclusive scan", "  CLK(5)\n", True),
    ("  const Interp q = make_interp(l);\n", "  CLK(6)\n", True),
    ("  asm volatile(\"barrier.cluster.wait.acquire.aligned;\\n\" ::: "
     "\"memory\");\n", "  CLK(7)\n"),
]
HISTEQ_PHASES_NEW = ("copy into shared memory", "min/max and its push",
                     "cluster barrier 1 and the combine",
                     "histogram sweep and block barrier",
                     "block histogram into rank 0", "cluster barrier 2",
                     "scan and CDF", "apply, write and the last wait")
PREPROC_PATCH_NEW = [
    ("namespace {\n", READER + CLK_NEW),
    ("  cg::cluster_group cl = cg::this_cluster();\n", "  CLKSET\n"),
    ("  int p = first;\n  if (p < planes) stage(p);\n", "  CLK(7)\n"),
    ("      if (vec) mbar_wait(&sm.bar[j], it & 1);\n", "      CLK(0)\n"),
    ("      stretch(buf, min(n, j * seg), min(n, j * seg + seg), st, lo, "
     "hi);\n", "      CLK(1)\n"),
    ("    cl.sync();\n    lo = INFINITY;", "    CLK(2)\n", True),
    ("    cl.sync();\n", "    CLK(3)\n"),
    ("    const Norm nm = make_norm(lo, hi, norm_min, norm_max);\n",
     "    CLK(4)\n", True),
    ("      normalise(buf, dst, min(n, j * seg), min(n, j * seg + seg), nm, "
     "vec);\n", "      CLK(5)\n"),
    ("        if (tid == 0 && next < planes) stage_seg(next, j);\n"
     "      }\n", "      CLK(6)\n"),
    ("      if (next < planes) stage(next);\n    }\n", "    CLK(6)\n"),
]
# K3's cluster route, over all the planes a block walks (thread 0's view)
PREPROC_PHASES_NEW = ("wait for the copy", "stretch", "reduce and push",
                      "cluster barrier", "combine",
                      "normalise and write", "block barrier and next copy",
                      "start and first copy")
# K7's phases are kept in thread 0's registers (32-bit clock) and written
# once at the end, so that reading the clock stalls nothing
CLK_REG = """#define CLKSET unsigned _t = (unsigned)clock(); \\
  unsigned _acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#define CLK(i) { unsigned _u = (unsigned)clock(); _acc[i] += _u - _t; \\
  _t = _u; }
#define CLKFLUSH { if (threadIdx.x == 0) for (int _i = 0; _i < 8; ++_i) \\
  g_clk[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + _i] = _acc[_i]; }
"""
CLAHE_PATCH_NEW = [
    ("namespace {\n", READER + CLK_REG),
    ("  cg::cluster_group cl = cg::this_cluster();\n", "  CLKSET\n"),
    ("    // min, max and the NaN flag over the cluster\n", "    CLK(0)\n",
     True),
    ("    cl.sync();\n    Lims l;\n", "    CLK(1)\n", True),
    ("    // each pixel binned once", "    CLK(2)\n", True),
    ("    // the values have been read", "    CLK(3)\n", True),
    ("    cl.sync();\n    // the next plane's rows land", "    CLK(4)\n",
     True),
    ("    // the next plane's rows land", "    CLK(5)\n", True),
    ("    // the blend, from shared memory\n", "    CLK(6)\n", True),
    ("    __syncthreads();  // the tables are read before the next plane's "
     "counts\n", "    CLK(7)\n"),
    ("    CLK(7)\n  }\n", "  CLKFLUSH\n"),
]
# K7's cluster route, over all the planes a block walks (thread 0's view)
CLAHE_PHASES_NEW = ("start and wait for the copy", "min/max and its push",
                    "cluster barrier 1 and the combine", "bin and count",
                    "the counts' push", "cluster barrier 2",
                    "next copy and tables", "blend and write")
CLAHE_SHAPES = ((32, 132, 132), (32, 640, 640))  # eval path, tile size
K3_SHAPES = ((32, 640, 640), (32, 132, 132))     # main path, eval path
# K4's backward at yolo11l@640's training batch: the incoming gradients of
# the two neck upsamples, [B, C, 2H, 2W]
K4_BWD_SHAPES = ((16, 512, 80, 80), (16, 512, 40, 40))
STATS_PHASES = ("min/max", "moments", "bisection", "pin")
STATS_PHASES_NEW = ("sweep", "block barrier wait", "block combine",
                    "cluster barrier", "cluster combine", "walk and trees",
                    "closing barrier", "copy to shared memory")
NMS_PHASES = ("load", "mask build", "scan")
NMS_PHASES_NEW = ("scan: copy the rows into shared memory",
                  "scan: the 32 decisions", "scan: keep flags and the "
                  "kept rows' words")


def patched(text: str, patch) -> str:
    for anchor, add, *before in patch:
        if text.count(anchor) != 1:
            raise SystemExit(f"anchor not found once: {anchor!r}")
        text = text.replace(anchor, add + anchor if before else anchor + add)
    return text + EXPORT


def is_new(csrc: str, name: str) -> bool:
    with open(os.path.join(csrc, f"{name}.cu")) as f:
        text = f.read()
    return {"stats": "clip_stats_cluster_kernel", "nms": "nms_scan_kernel",
            "histeq": "histeq_cluster_kernel",
            "preproc": "zscale_cluster_kernel",
            "clahe": "clahe_cluster_kernel"}[name] in text


def build_all(csrc: str, out_dir: str, names) -> dict[str, str]:
    from caesar_yolo_tpu_torch import cuda_build
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name in names:
        with open(os.path.join(csrc, f"{name}.cu")) as f:
            text = f.read()
        new = is_new(csrc, name)
        patch = {("stats", False): STATS_PATCH, ("nms", False): NMS_PATCH,
                 ("stats", True): STATS_PATCH_NEW,
                 ("nms", True): NMS_PATCH_NEW,
                 ("histeq", True): HISTEQ_PATCH_NEW,
                 ("preproc", True): PREPROC_PATCH_NEW,
                 ("clahe", True): CLAHE_PATCH_NEW}[name, new]
        variants = [("plain", text), ("clk", patched(text, patch))]
        for variant, src in variants:
            path = os.path.join(out_dir, f"{name}_{variant}.cu")
            with open(path, "w") as f:
                f.write(src)
            lib = os.path.join(out_dir, f"lib{name}_{variant}.so")
            cmd = [cuda_build._nvcc(), "-gencode",
                   "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                   "-shared", "-Xcompiler", "-fPIC", "-I", csrc,
                   *cuda_build.SOURCES[name], "-o", lib, path]
            jobs[f"{name}_{variant}"] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc {key} failed:\n{log}")
        libs[key] = lib
    return libs


def load(path, entry, argtypes):
    lib = ctypes.CDLL(path)
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib, fn


def clock_shares(torch, lib, call, blocks, phases):
    """Phase shares of the clock64 cycles of one call, summed over blocks;
    the most cycles a block took; how many blocks ran."""
    lib.cy_split_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int]
    lib.cy_split_clocks.restype = ctypes.c_int
    assert lib.cy_split_clocks(None, 0, 1) == 0
    call()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (NPH * blocks))()
    assert lib.cy_split_clocks(ctypes.addressof(buf), NPH * blocks, 0) == 0
    sums = [sum(buf[NPH * b + i] for b in range(blocks))
            for i in range(len(phases))]
    per_block_max = max(sum(buf[NPH * b:NPH * b + len(phases)])
                        for b in range(blocks))
    total = sum(sums)
    ran = sum(1 for b in range(blocks)
              if any(buf[NPH * b:NPH * b + len(phases)]))
    return ({p: s / total for p, s in zip(phases, sums)},
            per_block_max, ran)


def split_histeq_shift(torch, cs, dev, rng, kernels, libs, out):
    """K6 and K8 through the checkout's wrappers: CUDA events, device time
    per launch, bound and achieved bytes a second; the cluster-route K6's
    clock64 phases from libs["histeq_clk"] where it was built."""
    import math

    import numpy as np

    from caesar_yolo_tpu_torch import cuda_build
    from caesar_yolo_tpu_torch.ops import cuda_histeq, cuda_shift
    if "histeq" in kernels:
        crop = torch.from_numpy(rng.normal(0, 1, (1, 640, 640)).astype(
            np.float32)).to(dev)
        for shape, x in (("[32,512,512]", cs.mosaic_planes(dev, rng)),
                         ("[1,640,640]", crop)):
            call = lambda x=x: cuda_histeq.equalize_hist_batch(x)
            row = {"ms": cs.time_ms(torch, call),
                   "launch_ms": cs.kernel_split(torch, call),
                   "bound_ms": cs.bound_ms(2 * x.numel() * 4, 0,
                                           "float32")[0]}
            row["device_ms"] = sum(row["launch_ms"].values())
            if "histeq_clk" in libs:    # the cluster route's phases
                route, cluster, threads = cuda_histeq.plan(x[0].numel())
                lib, fn = load(libs["histeq_clk"], "cy_equalize_hist",
                               [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                               + [ctypes.c_void_p])
                y = torch.empty_like(x)
                shares, cyc, ran = clock_shares(
                    torch, lib, lambda fn=fn, x=x, y=y: fn(
                        x.data_ptr(), y.data_ptr(), None, None, x.shape[0],
                        x[0].numel(), cluster, threads, 0,
                        cuda_build.stream_ptr(dev)),
                    x.shape[0] * cluster, HISTEQ_PHASES_NEW)
                row["shares"] = shares
                row["split_ms"] = {k: v * row["device_ms"]
                                   for k, v in shares.items()}
                row["max_block_cycles"] = cyc
            print(f"K6 {shape}: {json.dumps(row)}", flush=True)
            out[f"K6 {shape}"] = row
    if "shift" in kernels:
        b, hp, pad = cs.TRAIN_BATCH, cs.SHIFT_CANVAS, cs.SHIFT_PAD
        g = torch.Generator(device=dev).manual_seed(0)
        imgs = torch.rand(b, hp, hp, 3, device=dev, generator=g)
        r = (torch.rand(b, device=dev, generator=g) * 2 - 1) * (math.pi / 4)
        cp = (cs.MAIN_SIZE - 1) / 2.0 + (hp - cs.MAIN_SIZE) // 2
        ys = torch.arange(hp, dtype=torch.float32, device=dev) - cp
        nbytes = 2 * imgs.numel() * 4 + b * hp * 4
        for name, view, shifts in (
                ("x-shear (rows)", imgs, -torch.tan(r)[:, None] * ys),
                ("y-shear (transposed view)", imgs.transpose(1, 2),
                 torch.tan(r)[:, None] * ys)):
            call = (lambda v=view, s=shifts: cuda_shift
                    .fractional_row_shift_batch(v, s, pad, 114.0 / 255.0))
            row = {"ms": cs.time_ms(torch, call),
                   "launch_ms": cs.kernel_split(torch, call),
                   "bound_ms": cs.bound_ms(nbytes, 4 * imgs.numel(),
                                           "float32")[0]}
            row["device_ms"] = sum(row["launch_ms"].values())
            row["bound_bytes_per_s_at_device_ms"] = (
                nbytes / (row["device_ms"] * 1e-3))
            print(f"K8 [16,1092,1092,3] {name}: {json.dumps(row)}",
                  flush=True)
            out[f"K8 {name}"] = row


def host_ms(torch, fn, iters=50):
    """Host time of one fn() in ms: the wrapper's work and the launch, with
    the device left to run behind (the events time is the larger of this
    and the device's)."""
    import time
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


def split_preproc_upsample(torch, cs, dev, rng, kernels, libs, out):
    """K3 and K4's backward through the checkout's wrappers: CUDA events,
    device time per launch and the bound; beside K3 the wrapper's
    zscale_limits, beside K4's backward the channels_last copy of the
    concat's channel slice that the parent's wrapper made."""
    from caesar_yolo_tpu_torch import cuda_build
    from caesar_yolo_tpu_torch.ops import cuda_preproc, cuda_upsample
    from caesar_yolo_tpu_torch.ops.zscale import zscale_limits
    if "preproc" in kernels:
        for shape in K3_SHAPES:
            x = cs.preproc_planes(dev, rng, shape)
            vlims = torch.stack(zscale_limits(x), dim=1)
            call = lambda x=x, v=vlims: cuda_preproc.zscale_minmax(x, v)
            limits = lambda x=x: zscale_limits(x)
            row = {"ms": cs.time_ms(torch, call),
                   "host_ms": host_ms(torch, call),
                   "launch_ms": cs.kernel_split(torch, call),
                   "bound_ms": cs.bound_ms(2 * x.numel() * 4
                                           + 2 * vlims.numel() * 4,
                                           12 * x.numel(), "float32")[0],
                   "zscale_limits_ms": cs.time_ms(torch, limits),
                   "zscale_limits_device_ms": cs.device_ms(torch, limits)}
            row["device_ms"] = sum(row["launch_ms"].values())
            # the C entry point alone, its arguments made once: the host
            # time left when the Python wrapper's is taken away
            route, *config = cuda_preproc.plan(x[0].numel())
            o, zl = torch.empty_like(x), torch.empty((x.shape[0], 2),
                                                      device=dev)
            args = (x.data_ptr(), vlims.data_ptr(), zl.data_ptr(),
                    o.data_ptr(), x.shape[0], x[0].numel(), 0.0, 1.0,
                    *config, int(route == "stream"),
                    cuda_build.stream_ptr(dev))
            row["entry_host_ms"] = host_ms(
                torch, lambda: cuda_preproc._entry()(*args))
            if "preproc_clk" in libs:     # the cluster route's phases
                cluster, segs = config
                lib, fn = load(libs["preproc_clk"], "cy_zscale_minmax",
                               cuda_preproc.ENTRY_ARGS)
                # at most one cluster a plane: slots past the grid stay 0
                shares, cyc, ran = clock_shares(
                    torch, lib, lambda: fn(
                        x.data_ptr(), vlims.data_ptr(), zl.data_ptr(),
                        o.data_ptr(), x.shape[0], x[0].numel(), 0.0, 1.0,
                        cluster, segs, 0,
                        cuda_build.stream_ptr(dev)),
                    cluster * x.shape[0], PREPROC_PHASES_NEW)
                row["shares"] = shares
                row["split_ms"] = {k: v * row["device_ms"]
                                   for k, v in shares.items()}
                row["max_block_cycles"] = cyc
            print(f"K3 {list(shape)}: {json.dumps(row)}", flush=True)
            out[f"K3 {list(shape)}"] = row
    if "upsample_bwd" in kernels:
        g = torch.Generator(device=dev).manual_seed(0)
        for b, c, h2, w2 in K4_BWD_SHAPES:
            full = torch.randn(b, 2 * c, h2, w2, device=dev, generator=g).to(
                torch.bfloat16).contiguous(memory_format=torch.channels_last)
            sl = full[:, :c]
            contig = sl.contiguous(memory_format=torch.channels_last)
            nbytes = 5 * contig.numel() // 4 * contig.element_size()
            for name, gy in (("contiguous", contig), ("concat slice", sl)):
                call = lambda gy=gy: cuda_upsample.upsample2x_backward(gy)
                row = {"ms": cs.time_ms(torch, call),
                       "host_ms": host_ms(torch, call),
                       "launch_ms": cs.kernel_split(torch, call),
                       "bound_ms": cs.bound_ms(nbytes, 0, "bfloat16")[0]}
                row["device_ms"] = sum(row["launch_ms"].values())
                print(f"K4-bwd {[b, c, h2, w2]} {name}: {json.dumps(row)}",
                      flush=True)
                out[f"K4-bwd {[b, c, h2, w2]} {name}"] = row
            copy = lambda: sl.contiguous(memory_format=torch.channels_last)
            row = {"ms": cs.time_ms(torch, copy),
                   "device_ms": cs.device_ms(torch, copy)}
            print(f"K4-bwd {[b, c, h2, w2]} channels_last copy of the slice: "
                  f"{json.dumps(row)}", flush=True)
            out[f"K4-bwd {[b, c, h2, w2]} slice copy"] = row


def split_clahe(torch, cs, dev, libs, out):
    """K7 through the checkout's wrapper: the whole call by CUDA events,
    its host time, device time per launch and the bound; the cluster
    route's clock64 phases from libs["clahe_clk"] where it was built."""
    from caesar_yolo_tpu_torch import cuda_build
    from caesar_yolo_tpu_torch.ops import clahe, cuda_clahe
    for shape in CLAHE_SHAPES:
        x = cs.clahe_planes(dev, *shape, seed=2, edge_cases=False)
        call = lambda x=x: cuda_clahe.equalize_adapthist_batch(x, 0.03)
        row = {"ms": cs.time_ms(torch, call), "host_ms": host_ms(torch, call),
               "launch_ms": cs.kernel_split(torch, call),
               "bound_ms": cs.bound_ms(2 * x.numel() * 4, 12 * x.numel(),
                                       "float32")[0]}
        row["device_ms"] = sum(row["launch_ms"].values())
        if "clahe_clk" in libs:     # the cluster route's phases
            route, cluster, rows, win = cuda_clahe.plan(*shape[1:])
            th, tw = clahe.tile_size(*shape[1:])
            o = torch.empty_like(x)
            args = (x.data_ptr(), o.data_ptr(), None, *shape, clahe.GRID, th,
                    tw, clahe.clip_limit_count(th * tw, 0.03), cluster,
                    rows, win, cuda_clahe.layout(*shape[1:], cluster)[2],
                    int(shape[2] % 4 == 0), 0, cuda_build.stream_ptr(dev))
            row["entry_host_ms"] = host_ms(
                torch, lambda: cuda_clahe._entry()(*args))
            lib, fn = load(libs["clahe_clk"], "cy_clahe",
                           cuda_clahe._entry().argtypes)
            shares, cyc, ran = clock_shares(torch, lib, lambda: fn(*args),
                                       cluster * shape[0], CLAHE_PHASES_NEW)
            row["shares"] = shares
            row["split_ms"] = {k: v * row["device_ms"]
                               for k, v in shares.items()}
            row["max_block_cycles"] = cyc
            row["resident_clusters"] = ran // cluster
        print(f"K7 {list(shape)}: {json.dumps(row)}", flush=True)
        out[f"K7 {list(shape)}"] = row


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from caesar_yolo_tpu_torch import cuda_build
    from caesar_yolo_tpu_torch.detect import cuda_nms, nms

    parser = argparse.ArgumentParser()
    parser.add_argument("--csrc", default=cuda_build.CSRC)
    parser.add_argument("--only",
                        default="stats,nms,histeq,shift,preproc,upsample_bwd,"
                        "clahe", help="comma-separated kernels to split")
    args = parser.parse_args()
    kernels = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    libs = build_all(args.csrc, os.path.join(REPO, "build", "split"),
                     [n for n in ("stats", "nms") if n in kernels]
                     + [n for n in ("histeq", "preproc", "clahe")
                        if n in kernels and is_new(args.csrc, n)])
    dev = torch.device("cuda")
    stream = cuda_build.stream_ptr(dev)
    out = {"card": card, "csrc": args.csrc}

    rng = np.random.default_rng(0)
    new_k5, new_k1 = is_new(args.csrc, "stats"), is_new(args.csrc, "nms")
    if "stats" in kernels:
        k5_args = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * (
                4 if new_k5 else 1) + [ctypes.c_void_p]
        planes = {"[32,512,512]": cs.mosaic_planes(dev, rng),
                  "[1,640,640]": torch.from_numpy(rng.normal(
                      0, 1, (1, 640, 640)).astype(np.float32)).to(dev)}
        for shape, x in planes.items():
            p, hw = x.shape[0], x[0].numel()
            stats = torch.empty((p, 5), device=dev)
            counts = torch.empty((p, 2), dtype=torch.int32, device=dev)
            extra, blocks, phases = (), p, STATS_PHASES
            if new_k5:
                from caesar_yolo_tpu_torch.ops import cuda_stats
                route, cluster, threads = cuda_stats.plan(hw)
                extra = (cluster, threads, int(route == "stream"))
                blocks, phases = p * cluster, STATS_PHASES_NEW
            row = {}
            for variant in ("plain", "clk"):
                lib, fn = load(libs[f"stats_{variant}"], "cy_sigma_clip_stats",
                               k5_args)
                call = (lambda fn=fn: fn(x.data_ptr(), stats.data_ptr(),
                                         counts.data_ptr(), p, hw, 3.0, 3.0, 5,
                                         *extra, stream))
                if variant == "plain":
                    row["ms"] = cs.time_ms(torch, call)
                    row["device_ms"] = cs.device_ms(torch, call)
                else:
                    shares, cyc, ran = clock_shares(torch, lib, call, blocks,
                                               phases)
                    row["shares"] = shares
                    row["split_ms"] = {k: v * row["device_ms"]
                                       for k, v in shares.items()}
                    row["max_block_cycles"] = cyc
            print(f"K5 {shape}: {json.dumps(row)}", flush=True)
            out[f"K5 {shape}"] = row

    if "nms" in kernels:
        boxes, scores = cs.synthetic_detections(
            rng, cs.MAIN_BATCH, sum((640 // s) ** 2 for s in (8, 16, 32)),
            640.0, tied=False)
        sel = nms._select_candidates(torch.from_numpy(boxes).to(dev),
                                     torch.from_numpy(scores).to(dev), 0.25,
                                     cs.PRE_NMS, False)
        boxes_t = sel[5].transpose(1, 2).contiguous()
        valid = sel[3].contiguous()
        b, _, k = boxes_t.shape
        alive = torch.empty((b, k), dtype=torch.bool, device=dev)
        scratch = torch.empty((b * k * (-(-k // 32)),), dtype=torch.int32,
                              device=dev)
        k1_args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_void_p]
        row = {"wrapper_ms": cs.time_ms(
            torch, lambda: cuda_nms.nms_suppress(boxes_t, valid, 0.5))}
        for variant in ("plain", "clk"):
            lib, fn = load(libs[f"nms_{variant}"], "cy_nms_suppress", k1_args)
            call = (lambda fn=fn: fn(boxes_t.data_ptr(), valid.data_ptr(),
                                     alive.data_ptr(), scratch.data_ptr(),
                                     b, k,
                                     0.5, stream))
            if variant == "plain":
                row["ms"] = cs.time_ms(torch, call)
                row["device_ms"] = cs.device_ms(torch, call)
                if new_k1:
                    row["launch_ms"] = cs.kernel_split(torch, call)
                ref = cuda_nms.suppress_plain(boxes_t.transpose(1, 2), valid,
                                              0.5)
                row["bit_equal"] = bool(torch.equal(alive, ref))
            else:
                # new K1: the scan launch's phases, scaled to its device time
                shares, cyc, ran = clock_shares(
                    torch, lib, call, b,
                    NMS_PHASES_NEW if new_k1 else NMS_PHASES)
                scale = (sum(v for n, v in row["launch_ms"].items()
                             if "scan" in n) if new_k1 else row["device_ms"])
                row["shares"] = shares
                row["split_ms"] = {kk: v * scale for kk, v in shares.items()}
                row["max_block_cycles"] = cyc
        print(f"K1 [32,4,512]: {json.dumps(row)}", flush=True)
        out["K1 [32,4,512]"] = row
    split_histeq_shift(torch, cs, dev, rng, kernels, libs, out)
    split_preproc_upsample(torch, cs, dev, rng, kernels, libs, out)
    if "clahe" in kernels:
        split_clahe(torch, cs, dev, libs, out)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "kernel_split.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
