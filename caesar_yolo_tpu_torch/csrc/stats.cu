// Sigma-clipped statistics of masked planes (kernel K5).
//
// Replaces caesar_yolo_tpu/ops/pallas_stats.py:sigma_clipped_stats_batch
// (_sigma_clip_kernel), which holds one tile in VMEM and runs the whole
// astropy clip loop on it: 5 iterations, each a 24-round value-domain
// bisection for the two middle order statistics (k2's bracket shares
// k1's until they split) with an exact pin, plus masked moments; the
// kept set is the intersection of every iteration's bounds.  Same
// arithmetic as the plain version (caesar_yolo_tpu_torch/ops/stats.py),
// in the same order, built with -fmad=false and explicitly rounded
// intrinsics, so medians equal it exactly wherever the kept sets agree.
//
// The mask is derived from the values (finite and != 0), as all callers
// pass valid_mask of the values they pass: the kernel reads the f32
// plane only.
//
// Design: one block of 1024 threads per plane.  A GPU block cannot hold
// a 512x512 plane (1 MB) in shared memory or registers, so every probe
// re-reads the plane (from L2: 32 planes of 512^2 are 32 MB, within the
// H100's 50 MB) with float4 loads: 1 pass for n_valid/min/max, then per
// iteration 1 moments pass, 24 bisection passes (both counts in one
// pass) and 2 pin passes; 163 passes in all.  Each probe ends in a
// block-wide reduction in a fixed order (warp butterfly, then the warp
// partials in warp order), so sums are deterministic; no float atomics.
//
// Bound on an H100: read each plane once, P*H*W*4 bytes (32 MB at
// [32, 512, 512], ~10 us at 3.35 TB/s).  This version is bound instead
// by the 163 L2 passes of one SM per plane: one block per plane leaves
// 100 of 132 SMs idle at 32 planes.
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 24;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nanf_() { return __int_as_float(0x7fc00000); }

// torch.maximum / jnp.maximum: NaN propagates (fmaxf would drop it)
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? nanf_() : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? nanf_() : fminf(a, b);
}

__device__ __forceinline__ bool valid_px(float v) {
  return v != 0.0f && isfinite(v);
}

// Calls f(v) for every value of the plane owned by this thread, in a fixed
// order per thread.
template <typename F>
__device__ __forceinline__ void scan(const float* __restrict__ xp, int hw,
                                     bool vec4, F&& f) {
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(xp);
    const int n4 = hw >> 2;
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const float4 v = __ldg(x4 + i);
      f(v.x);
      f(v.y);
      f(v.z);
      f(v.w);
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += kThreads) f(__ldg(xp + i));
  }
}

// Block-wide reductions; every thread gets the result.  `s` holds N*kWarps
// slots; the second barrier makes it reusable at once.
template <int N>
__device__ __forceinline__ void block_sum(int (&v)[N], int* s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = __reduce_add_sync(kFull, v[j]);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) s[j * kWarps + warp] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += s[j * kWarps + w];
    v[j] = t;
  }
  __syncthreads();
}

// kind 0: sum (butterfly within the warp -- every lane adds the same two
// values, so all lanes agree bit for bit -- then warp partials in order);
// kind 1: min; kind 2: max.
template <int N>
__device__ __forceinline__ void block_reduce(float (&v)[N], const int (&kind)[N],
                                             float* s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(kFull, v[j], o);
      v[j] = kind[j] == 0 ? __fadd_rn(v[j], u)
                          : (kind[j] == 1 ? fminf(v[j], u) : fmaxf(v[j], u));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) s[j * kWarps + warp] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float t = s[j * kWarps];
    for (int w = 1; w < kWarps; ++w) {
      const float u = s[j * kWarps + w];
      t = kind[j] == 0 ? __fadd_rn(t, u)
                       : (kind[j] == 1 ? fminf(t, u) : fmaxf(t, u));
    }
    v[j] = t;
  }
  __syncthreads();
}

struct Reductions {
  int i[2 * kWarps];
  float f[4 * kWarps];
};

struct Stats {
  int n;
  float med, mean, std;
};

// (n, median, mean, std) of the valid values in [lo, up]
// (ops/stats.py:_stats_of; pallas_stats.py:103-117).
__device__ Stats stats_of(const float* __restrict__ xp, int hw, bool vec4,
                          float lo, float up, float lo0, float vmax,
                          Reductions& red) {
  const float inf = INFINITY;
  // keep -> the value, else +inf (the reference's xm)
  auto xm_of = [lo, up, inf](float v) {
    return (valid_px(v) && v >= lo && v <= up) ? v : inf;
  };

  int n[1] = {0};
  float mom[2] = {0.0f, 0.0f};
  scan(xp, hw, vec4, [&](float v) {
    if (xm_of(v) != inf) {
      n[0] += 1;
      mom[0] = __fadd_rn(mom[0], v);
      mom[1] = __fadd_rn(mom[1], __fmul_rn(v, v));
    }
  });
  block_sum<1>(n, red.i);
  const int sums[2] = {0, 0};
  block_reduce<2>(mom, sums, red.f);

  const int ni = n[0] > 1 ? n[0] : 1;
  const int k1 = (ni + 1) / 2, k2 = ni / 2 + 1;
  const float nf = (float)ni;
  const float mean = __fdiv_rn(mom[0], nf);
  const float var =
      jmax(__fsub_rn(__fdiv_rn(mom[1], nf), __fmul_rn(mean, mean)), 0.0f);

  // shared binary bisection for the k1-th and k2-th order statistics:
  // invariant count(<= lo) < k <= count(<= hi)
  float lo1 = lo0, hi1 = vmax, lo2 = lo0, hi2 = vmax;
  for (int r = 0; r < kRounds; ++r) {
    const float mid1 = __fmul_rn(0.5f, __fadd_rn(lo1, hi1));
    const float mid2 = __fmul_rn(0.5f, __fadd_rn(lo2, hi2));
    int c[2] = {0, 0};
    scan(xp, hw, vec4, [&](float v) {
      const float xm = xm_of(v);
      c[0] += xm <= mid1;
      c[1] += xm <= mid2;
    });
    block_sum<2>(c, red.i);
    if (c[0] >= k1) hi1 = mid1; else lo1 = mid1;
    if (c[1] >= k2) hi2 = mid2; else lo2 = mid2;
  }

  // exact pin (pallas_stats.py:79-85): the k-th value is the smallest
  // bracket member whose cumulative count reaches k; else the next
  // distinct member; else the bracket top
  float m1[2] = {inf, inf};
  scan(xp, hw, vec4, [&](float v) {
    const float xm = xm_of(v);
    if (xm > lo1 && xm <= hi1) m1[0] = fminf(m1[0], xm);
    if (xm > lo2 && xm <= hi2) m1[1] = fminf(m1[1], xm);
  });
  const int mins2[2] = {1, 1};
  block_reduce<2>(m1, mins2, red.f);
  int c1[2] = {0, 0};
  float m2[2] = {inf, inf};
  scan(xp, hw, vec4, [&](float v) {
    const float xm = xm_of(v);
    c1[0] += xm <= m1[0];
    c1[1] += xm <= m1[1];
    if (xm > lo1 && xm <= hi1 && xm > m1[0]) m2[0] = fminf(m2[0], xm);
    if (xm > lo2 && xm <= hi2 && xm > m1[1]) m2[1] = fminf(m2[1], xm);
  });
  block_sum<2>(c1, red.i);
  block_reduce<2>(m2, mins2, red.f);
  const float r1 = c1[0] >= k1 ? m1[0] : (isfinite(m2[0]) ? m2[0] : hi1);
  const float r2 = c1[1] >= k2 ? m1[1] : (isfinite(m2[1]) ? m2[1] : hi2);

  Stats st;
  st.n = n[0];
  st.med = __fmul_rn(0.5f, __fadd_rn(r1, k2 == k1 ? r1 : r2));
  st.mean = mean;
  st.std = __fsqrt_rn(var);
  return st;
}

__global__ void __launch_bounds__(kThreads)
clip_stats_kernel(const float* __restrict__ x, int hw, bool vec4,
                  float sigma_low, float sigma_up, int maxiters,
                  float* __restrict__ stats, int* __restrict__ counts) {
  __shared__ Reductions red;
  const int p = blockIdx.x;
  const float* xp = x + (size_t)p * hw;
  const float inf = INFINITY;

  int nv[1] = {0};
  float mm[2] = {inf, -inf};
  scan(xp, hw, vec4, [&](float v) {
    if (valid_px(v)) {
      nv[0] += 1;
      mm[0] = fminf(mm[0], v);
      mm[1] = fmaxf(mm[1], v);
    }
  });
  block_sum<1>(nv, red.i);
  const int minmax[2] = {1, 2};
  block_reduce<2>(mm, minmax, red.f);
  float* out = stats + (size_t)p * 5;
  if (nv[0] == 0) {  // the same for every thread of the block
    if (threadIdx.x == 0) {
      for (int j = 0; j < 5; ++j) out[j] = nanf_();
      counts[2 * p] = 0;
      counts[2 * p + 1] = 0;
    }
    return;
  }
  const float vmin = mm[0], vmax = mm[1];
  const float d = __fsub_rn(vmax, vmin);
  const float span = d < 0.0f ? 0.0f : d;
  // strictly below vmin even for large-magnitude values (f32 rounding)
  const float lo0 = __fsub_rn(
      __fsub_rn(vmin, __fmul_rn(jmax(span, fabsf(vmin)), 1e-5f)), 1e-30f);

  float lo_acc = -inf, up_acc = inf, lower = -inf, upper = inf;
  for (int it = 0; it < maxiters; ++it) {
    const Stats st = stats_of(xp, hw, vec4, lo_acc, up_acc, lo0, vmax, red);
    lower = __fsub_rn(st.med, __fmul_rn(sigma_low, st.std));
    upper = __fadd_rn(st.med, __fmul_rn(sigma_up, st.std));
    lo_acc = jmax(lo_acc, lower);
    up_acc = jmin(up_acc, upper);
  }
  const Stats st = stats_of(xp, hw, vec4, lo_acc, up_acc, lo0, vmax, red);
  if (threadIdx.x == 0) {
    out[0] = st.mean;
    out[1] = st.med;
    out[2] = st.std;
    out[3] = lower;
    out[4] = upper;
    counts[2 * p] = nv[0];
    counts[2 * p + 1] = st.n;
  }
}

}  // namespace

extern "C" {

// x [P, HW] f32 planes -> stats [P, 5] f32 (mean, median, std, lower,
// upper; NaN on a plane with no valid pixel) and counts [P, 2] int32
// (n_valid, final kept count).
int cy_sigma_clip_stats(const float* x, float* stats, int* counts, int planes,
                        int hw, float sigma_low, float sigma_up, int maxiters,
                        cudaStream_t stream) {
  if (planes == 0) return (int)cudaSuccess;
  const bool vec4 =
      hw % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  clip_stats_kernel<<<planes, kThreads, 0, stream>>>(
      x, hw, vec4, sigma_low, sigma_up, maxiters, stats, counts);
  return (int)cudaGetLastError();
}

}  // extern "C"
