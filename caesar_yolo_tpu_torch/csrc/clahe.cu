// Contrast-limited adaptive histogram equalisation of planes (kernel K7).
//
// Replaces caesar_yolo_tpu/ops/pallas_clahe.py:equalize_adapthist_batch
// (_hist_kernel, _blend_kernel): per-contextual-tile 256-bin histograms on
// an 8x8 grid over the reflect-padded plane, then (in PyTorch, between the
// launches, shared with the plain version) clip + redistribution and the
// CDFs, then every pixel through the bilinear blend of its 4 neighbouring
// tiles' CDFs.  The TPU kernels avoided scatter and gather (an occupied-span
// count loop per tile, a telescoping hat-weight sum per pixel); on a GPU
// both are cheap, so this is the XLA gather form of
// caesar_yolo_tpu_torch/ops/clahe.py, in the same order of operations,
// built with -fmad=false and explicitly rounded intrinsics so that its
// output equals the plain version bit for bit.
//
// Design, two launches over planes [P, H, W]:
//   hist   one block per (contextual tile, plane); threads stride over the
//          tile's th*tw padded pixels, map each padded index to its source
//          pixel inline (i < n ? i : 2*(n-1) - i, jnp.pad's reflect; no
//          padded copy), bin it and count it in per-warp shared-memory
//          histograms with warp-aggregated integer atomics; the block sums
//          the warps' counts (exact) and writes f32 counts [P, g*g, 256];
//   blend  one thread per output pixel: its bin, its two tile rows and
//          columns with their weights, four loads of cdf[tile][bin] (the
//          plane's 64 KiB table stays in L1/L2), and the blend as lerps,
//          top = v00 + fx*(v01 - v00), bot = v10 + fx*(v11 - v10),
//          top + fy*(bot - top) (a uniform plane stays uniform).
//
// Bound on an H100: bytes.  hist reads each plane once and writes its
// counts; blend reads the plane and its table once and writes the output:
// 2 reads + 1 write of P*H*W*4 bytes over both (157 MB at [32, 640, 640],
// ~47 us at 3.35 TB/s).  Both launches recompute the bins from x.
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr unsigned kFull = 0xffffffffu;

// clip(int(v), 0, hi) with int(NaN) = 0, as XLA converts
__device__ __forceinline__ int to_index(float v, int hi) {
  if (isnan(v)) return 0;
  v = v < 0.0f ? 0.0f : v;
  v = v > (float)hi ? (float)hi : v;
  return (int)v;
}

__device__ __forceinline__ int bin_of(float x, float vmin, float span) {
  const float scaled =
      __fmul_rn(__fdiv_rn(__fsub_rn(x, vmin), span), (float)kBins);
  return to_index(scaled, kBins - 1);
}

// source index of padded position i of an axis of n (reflect at the end)
__device__ __forceinline__ int reflect(int i, int n) {
  return i < n ? i : 2 * (n - 1) - i;
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const float* __restrict__ x, const float* __restrict__ vmin,
            const float* __restrict__ span, float* __restrict__ hist, int h,
            int w, int grid, int th, int tw) {
  __shared__ int wh[kWarps][kBins];
  const int t = blockIdx.x, p = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads)
    (&wh[0][0])[i] = 0;
  __syncthreads();
  const float lo = vmin[p], sp = span[p];
  const float* xp = x + (size_t)p * h * w;
  const int y0 = (t / grid) * th, x0 = (t % grid) * tw;
  const int n = th * tw;
  // every lane of a warp runs the same iterations, so the warp-wide match
  // sees all 32 lanes; lanes past the tile carry bin -1
  for (int base = threadIdx.x - lane; base < n; base += kThreads) {
    const int i = base + lane;
    int b = -1;
    if (i < n) {
      const int sy = reflect(y0 + i / tw, h), sx = reflect(x0 + i % tw, w);
      b = bin_of(__ldg(xp + (size_t)sy * w + sx), lo, sp);
    }
    const unsigned same = __match_any_sync(kFull, b);
    if (b >= 0 && lane == __ffs(same) - 1)
      atomicAdd(&wh[warp][b], __popc(same));
  }
  __syncthreads();
  float* out = hist + ((size_t)p * grid * grid + t) * kBins;
  for (int b = threadIdx.x; b < kBins; b += kThreads) {
    int c = 0;
    for (int v = 0; v < kWarps; ++v) c += wh[v][b];
    out[b] = (float)c;
  }
}

struct Tap {
  int t0, t1;
  float f;
};

// the two neighbouring tiles of row (column) i and the second's weight:
// t = (i + 0.5) / tsize - 0.5 on clamped tile coordinates
__device__ __forceinline__ Tap tap(int i, int tsize, int grid) {
  const float c =
      __fsub_rn(__fdiv_rn(__fadd_rn((float)i, 0.5f), (float)tsize), 0.5f);
  float t0 = floorf(c);
  t0 = t0 < 0.0f ? 0.0f : t0;
  t0 = t0 > (float)(grid - 1) ? (float)(grid - 1) : t0;
  float f = __fsub_rn(c, t0);
  f = f < 0.0f ? 0.0f : f;
  f = f > 1.0f ? 1.0f : f;
  Tap r;
  r.t0 = (int)t0;
  r.t1 = r.t0 + 1 < grid ? r.t0 + 1 : grid - 1;
  r.f = f;
  return r;
}

__global__ void __launch_bounds__(kThreads)
blend_kernel(const float* __restrict__ x, const float* __restrict__ vmin,
             const float* __restrict__ span, const float* __restrict__ cdf,
             float* __restrict__ out, int h, int w, int grid, int th,
             int tw) {
  const int p = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= h * w) return;
  const size_t at = (size_t)p * h * w + i;
  const int b = bin_of(__ldg(x + at), vmin[p], span[p]);
  const Tap ty = tap(i / w, th, grid), tx = tap(i % w, tw, grid);
  const float* tab = cdf + (size_t)p * grid * grid * kBins + b;
  const float v00 = __ldg(tab + (ty.t0 * grid + tx.t0) * kBins);
  const float v01 = __ldg(tab + (ty.t0 * grid + tx.t1) * kBins);
  const float v10 = __ldg(tab + (ty.t1 * grid + tx.t0) * kBins);
  const float v11 = __ldg(tab + (ty.t1 * grid + tx.t1) * kBins);
  const float top = __fadd_rn(v00, __fmul_rn(tx.f, __fsub_rn(v01, v00)));
  const float bot = __fadd_rn(v10, __fmul_rn(tx.f, __fsub_rn(v11, v10)));
  out[at] = __fadd_rn(top, __fmul_rn(ty.f, __fsub_rn(bot, top)));
}

}  // namespace

extern "C" {

// x [P, H, W] f32, vmin/span [P] f32 -> hist [P, grid*grid, 256] f32
// counts of the contextual tiles (th x tw each) of the reflect-padded plane.
int cy_clahe_hist(const float* x, const float* vmin, const float* span,
                  float* hist, int planes, int h, int w, int grid, int th,
                  int tw, cudaStream_t stream) {
  if (planes == 0) return (int)cudaSuccess;
  hist_kernel<<<dim3(grid * grid, planes), kThreads, 0, stream>>>(
      x, vmin, span, hist, h, w, grid, th, tw);
  return (int)cudaGetLastError();
}

// x [P, H, W] f32, vmin/span [P], cdf [P, grid*grid, 256] f32 -> out
// [P, H, W] f32, each pixel the blend of its 4 neighbouring tiles' CDFs.
int cy_clahe_blend(const float* x, const float* vmin, const float* span,
                   const float* cdf, float* out, int planes, int h, int w,
                   int grid, int th, int tw, cudaStream_t stream) {
  if (planes == 0 || h * w == 0) return (int)cudaSuccess;
  blend_kernel<<<dim3((h * w + kThreads - 1) / kThreads, planes), kThreads,
                 0, stream>>>(x, vmin, span, cdf, out, h, w, grid, th, tw);
  return (int)cudaGetLastError();
}

}  // extern "C"
