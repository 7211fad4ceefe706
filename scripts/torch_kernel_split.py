#!/usr/bin/env python3
"""Split the time of K5 (csrc/stats.cu) and K1 (csrc/nms.cu) on one CUDA
card, for either design: the one-block-per-plane K5 and one-block-per-
image K1 up to commit 0a0e8d7, or the cluster-per-plane K5 and the
two-launch K1 after it (told apart by their sources).

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

Run from the repository root (default: the checkout's own csrc/), or
pointing at the csrc/ of another checkout (e.g. the parent unpacked
with `git archive` into build/):
    python3 scripts/torch_kernel_split.py \
        [--csrc <dir>/caesar_yolo_tpu_torch/csrc]
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
    return ("clip_stats_cluster_kernel" in text if name == "stats"
            else "nms_scan_kernel" in text)


def build_all(csrc: str, out_dir: str) -> dict[str, str]:
    from caesar_yolo_tpu_torch import cuda_build
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name in ("stats", "nms"):
        with open(os.path.join(csrc, f"{name}.cu")) as f:
            text = f.read()
        new = is_new(csrc, name)
        patch = {("stats", False): STATS_PATCH, ("nms", False): NMS_PATCH,
                 ("stats", True): STATS_PATCH_NEW,
                 ("nms", True): NMS_PATCH_NEW}[name, new]
        variants = [("plain", text), ("clk", patched(text, patch))]
        for variant, src in variants:
            path = os.path.join(out_dir, f"{name}_{variant}.cu")
            with open(path, "w") as f:
                f.write(src)
            lib = os.path.join(out_dir, f"lib{name}_{variant}.so")
            cmd = [cuda_build._nvcc(), "-gencode",
                   "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                   "-shared", "-Xcompiler", "-fPIC",
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
    """Phase shares of the clock64 cycles of one call, summed over blocks."""
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
    return ({p: s / total for p, s in zip(phases, sums)},
            per_block_max)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from caesar_yolo_tpu_torch import cuda_build
    from caesar_yolo_tpu_torch.detect import cuda_nms, nms

    parser = argparse.ArgumentParser()
    parser.add_argument("--csrc", default=cuda_build.CSRC)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    libs = build_all(args.csrc, os.path.join(REPO, "build", "split"))
    dev = torch.device("cuda")
    stream = cuda_build.stream_ptr(dev)
    out = {"card": card, "csrc": args.csrc}

    new_k5, new_k1 = is_new(args.csrc, "stats"), is_new(args.csrc, "nms")
    k5_args = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * (
            4 if new_k5 else 1) + [ctypes.c_void_p]
    rng = np.random.default_rng(0)
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
                shares, cyc = clock_shares(torch, lib, call, blocks, phases)
                row["shares"] = shares
                row["split_ms"] = {k: v * row["device_ms"]
                                   for k, v in shares.items()}
                row["max_block_cycles"] = cyc
        print(f"K5 {shape}: {json.dumps(row)}", flush=True)
        out[f"K5 {shape}"] = row

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
                                 alive.data_ptr(), scratch.data_ptr(), b, k,
                                 0.5, stream))
        if variant == "plain":
            row["ms"] = cs.time_ms(torch, call)
            row["device_ms"] = cs.device_ms(torch, call)
            if new_k1:
                row["launch_ms"] = {
                    n.split("::")[-1].split("(")[0]: v for n, v in
                    cs.device_ms(torch, call, by_kernel=True).items()}
            ref = cuda_nms.suppress_plain(boxes_t.transpose(1, 2), valid,
                                          0.5)
            row["bit_equal"] = bool(torch.equal(alive, ref))
        else:
            # new K1: the scan launch's phases, scaled to its device time
            shares, cyc = clock_shares(
                torch, lib, call, b, NMS_PHASES_NEW if new_k1 else NMS_PHASES)
            scale = (sum(v for n, v in row["launch_ms"].items()
                         if "scan" in n) if new_k1 else row["device_ms"])
            row["shares"] = shares
            row["split_ms"] = {kk: v * scale for kk, v in shares.items()}
            row["max_block_cycles"] = cyc
    print(f"K1 [32,4,512]: {json.dumps(row)}", flush=True)
    out["K1 [32,4,512]"] = row
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "kernel_split.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
