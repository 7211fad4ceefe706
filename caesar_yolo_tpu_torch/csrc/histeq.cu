// Histogram equalisation of planes (kernel K6).
//
// Replaces caesar_yolo_tpu/ops/pallas_histeq.py:equalize_hist_batch
// (_hist_kernel, _lut_kernel): skimage equalize_hist with 256 bins over
// each plane's [min, max], the CDF normalised by its last entry, and
// linear interpolation at the bin centres.  The TPU kernels avoided
// scatter and gather (one vector reduce per occupied bin, and a "ramp
// identity" in place of the LUT gather); on a GPU both are cheap, so this
// is the plain formulation (caesar_yolo_tpu_torch/ops/histeq.py), in the
// same order of operations, built with -fmad=false and explicitly rounded
// intrinsics so that its output equals the plain version bit for bit.
//
// Design, four launches over planes [P, HW], each spread over kBlocks
// blocks per plane so that every SM takes part:
//   init     sets lims[P] to (+inf, -inf, no NaN) and hist[P, 256] to 0;
//   minmax   the whole plane's min/max (jnp.min semantics: a NaN anywhere
//            makes vmin = vmax = NaN), merged across blocks with integer
//            atomics on order-preserving encodings (exact: min/max are
//            order-free);
//   hist     per-warp shared-memory histograms with warp-aggregated
//            integer atomics, merged into hist[P, 256] with global
//            integer atomics (exact: the counts are integers);
//   apply    builds the 256-entry CDF in shared memory and interpolates.
//
// Bound on an H100: read each plane once and write it once, 2*P*HW*4
// bytes (64 MB at [32, 512, 512], ~20 us at 3.35 TB/s).  This version
// reads the input three times.
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 32;  // blocks per plane
constexpr int kBins = 256;
constexpr unsigned kFull = 0xffffffffu;

// float -> int whose signed order is the float order (no NaN)
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// clip(int(v), 0, hi) with int(NaN) = 0, as XLA converts
__device__ __forceinline__ int to_index(float v, int hi) {
  if (isnan(v)) return 0;
  v = v < 0.0f ? 0.0f : v;
  v = v > (float)hi ? (float)hi : v;
  return (int)v;
}

struct Lims {
  float vmin, span;
};

// lims: [P, 3] int = ordered min, ordered max, NaN flag
__device__ __forceinline__ Lims plane_lims(const int* lims, int p) {
  Lims l;
  if (lims[3 * p + 2]) {
    l.vmin = __int_as_float(0x7fc00000);
    l.span = 1.0f;  // NaN > NaN is false
    return l;
  }
  const float vmin = unordered(lims[3 * p]);
  const float vmax = unordered(lims[3 * p + 1]);
  l.vmin = vmin;
  l.span = vmax > vmin ? __fsub_rn(vmax, vmin) : 1.0f;
  return l;
}

__device__ __forceinline__ int bin_of(float x, Lims l) {
  const float scaled =
      __fmul_rn(__fdiv_rn(__fsub_rn(x, l.vmin), l.span), (float)kBins);
  return to_index(scaled, kBins - 1);
}

__global__ void init_kernel(int* __restrict__ lims, int* __restrict__ hist,
                            int planes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < planes) {
    lims[3 * i] = ordered(INFINITY);
    lims[3 * i + 1] = ordered(-INFINITY);
    lims[3 * i + 2] = 0;
  }
  if (i < planes * kBins) hist[i] = 0;
}

__global__ void __launch_bounds__(kThreads)
minmax_kernel(const float* __restrict__ x, int* __restrict__ lims, int hw) {
  const int p = blockIdx.y;
  const float* xp = x + (size_t)p * hw;
  float lo = INFINITY, hi = -INFINITY;
  int nan = 0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < hw;
       i += kBlocks * kThreads) {
    const float v = __ldg(xp + i);
    nan |= isnan(v);
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
  }
  nan = __reduce_or_sync(kFull, nan);
  __shared__ float slo[kWarps], shi[kWarps];
  __shared__ int snan[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    slo[warp] = lo;
    shi[warp] = hi;
    snan[warp] = nan;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      lo = fminf(lo, slo[w]);
      hi = fmaxf(hi, shi[w]);
      nan |= snan[w];
    }
    if (nan) atomicOr(lims + 3 * p + 2, 1);
    if (lo <= hi) {
      atomicMin(lims + 3 * p, ordered(lo));
      atomicMax(lims + 3 * p + 1, ordered(hi));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const float* __restrict__ x, const int* __restrict__ lims,
            int* __restrict__ hist, int hw) {
  __shared__ int wh[kWarps][kBins];
  const int p = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads)
    (&wh[0][0])[i] = 0;
  __syncthreads();
  const Lims l = plane_lims(lims, p);
  const float* xp = x + (size_t)p * hw;
  // every lane runs the same number of iterations, so the warp-wide
  // match below sees all 32 lanes; lanes past the end carry bin -1
  const int stride = kBlocks * kThreads;
  const int base = blockIdx.x * kThreads + threadIdx.x - lane;
  for (int i0 = base; i0 < hw; i0 += stride) {
    const int i = i0 + lane;
    const int b = i < hw ? bin_of(__ldg(xp + i), l) : -1;
    const unsigned same = __match_any_sync(kFull, b);
    if (b >= 0 && lane == __ffs(same) - 1)
      atomicAdd(&wh[warp][b], __popc(same));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += kThreads) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += wh[w][b];
    if (t) atomicAdd(hist + (size_t)p * kBins + b, t);
  }
}

__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ x, const int* __restrict__ lims,
             const int* __restrict__ hist, float* __restrict__ out, int hw) {
  __shared__ float cdf[kBins];
  __shared__ int cum[kBins];
  const int p = blockIdx.y;
  if (threadIdx.x < kBins) cum[threadIdx.x] = hist[(size_t)p * kBins + threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) {  // 256 integer adds: exact in any order
    for (int b = 1; b < kBins; ++b) cum[b] += cum[b - 1];
  }
  __syncthreads();
  if (threadIdx.x < kBins)
    cdf[threadIdx.x] =
        __fdiv_rn((float)cum[threadIdx.x], (float)cum[kBins - 1]);
  __syncthreads();

  const Lims l = plane_lims(lims, p);
  const float step = __fdiv_rn(l.span, (float)kBins);
  const float c0 = __fadd_rn(l.vmin, __fmul_rn(0.5f, step));
  const float* xp = x + (size_t)p * hw;
  float* op = out + (size_t)p * hw;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < hw;
       i += kBlocks * kThreads) {
    float pos = __fdiv_rn(__fsub_rn(__ldg(xp + i), c0), step);
    // jnp.clip: NaN stays NaN
    pos = pos < 0.0f ? 0.0f : pos;
    pos = pos > (float)(kBins - 1) ? (float)(kBins - 1) : pos;
    const int i0 = to_index(pos, kBins - 2);
    float f = __fsub_rn(pos, (float)i0);
    f = f < 0.0f ? 0.0f : f;
    f = f > 1.0f ? 1.0f : f;
    op[i] = __fadd_rn(__fmul_rn(cdf[i0], __fsub_rn(1.0f, f)),
                      __fmul_rn(cdf[i0 + 1], f));
  }
}

}  // namespace

extern "C" {

// x [P, HW] f32 -> out [P, HW] f32 in [0, 1] (NaN on a plane holding a
// NaN).  Scratch: lims [P, 3] int32, hist [P, 256] int32.
int cy_equalize_hist(const float* x, float* out, int* lims, int* hist,
                     int planes, int hw, cudaStream_t stream) {
  if (planes == 0 || hw == 0) return (int)cudaSuccess;
  init_kernel<<<(planes * kBins + kThreads - 1) / kThreads, kThreads, 0,
                stream>>>(lims, hist, planes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(kBlocks, planes);
  minmax_kernel<<<grid, kThreads, 0, stream>>>(x, lims, hw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hist_kernel<<<grid, kThreads, 0, stream>>>(x, lims, hist, hw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_kernel<<<grid, kThreads, 0, stream>>>(x, lims, hist, out, hw);
  return (int)cudaGetLastError();
}

}  // extern "C"
