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
// Min/max are exact in any order and the bin counts are integers, so
// neither depends on how the work is split.
//
// Two routes, chosen by the plane's size alone (ops/cuda_histeq.py:plan).
//  - Cluster route, one launch: one thread-block cluster of up to 16
//    blocks a plane (grid [cluster, planes]).  Each block bulk-copies its
//    contiguous part of the plane into shared memory once (cp.async.bulk
//    on an mbarrier; 4-byte cp.async where the part is not 16-byte
//    aligned), so the plane is read from device memory once and written
//    once.  Min/max and the NaN flag are pushed to every block of the
//    cluster through distributed shared memory; after one cluster barrier
//    each block combines them.  The histogram is built from shared memory
//    into per-warp shared histograms with shared-memory atomics, summed
//    over the block and added into rank 0's histogram through distributed
//    shared memory; after a second cluster barrier every block reads it,
//    scans it (a warp-parallel inclusive scan, eight warps of 32 bins) and
//    interpolates its part from shared memory, writing float4s.
//  - Stream route (planes too large for a cluster's shared memory): four
//    launches spread over kStreamBlocks blocks a plane, reading the plane
//    three times: init (limits and histograms), minmax (integer atomics
//    on order-preserving encodings), hist (per-warp histograms, merged
//    with global integer atomics) and apply.
//
// Bound on an H100: read each plane once and write it once, 2*P*HW*4
// bytes (64 MB at [32, 512, 512], ~20 us at 3.35 TB/s).  On the cluster
// route 32 planes of 1 MB exceed the SMs' ~30 MB of shared memory: two
// waves.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace acopy;

constexpr int kBins = 256;
constexpr int kMaxCluster = 16;
constexpr int kStreamThreads = 256;
constexpr int kStreamWarps = kStreamThreads / 32;
constexpr int kStreamBlocks = 32;  // blocks per plane on the stream route
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnschedulable = -1;

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

// jnp.min / max semantics: a NaN anywhere makes vmin = vmax = NaN, and
// then span = 1 (NaN > NaN is false)
__device__ __forceinline__ Lims make_lims(float lo, float hi, bool nan) {
  Lims l;
  if (nan) {
    l.vmin = __int_as_float(0x7fc00000);
    l.span = 1.0f;
    return l;
  }
  l.vmin = lo;
  l.span = hi > lo ? __fsub_rn(hi, lo) : 1.0f;
  return l;
}

__device__ __forceinline__ int bin_of(float x, Lims l) {
  const float scaled =
      __fmul_rn(__fdiv_rn(__fsub_rn(x, l.vmin), l.span), (float)kBins);
  return to_index(scaled, kBins - 1);
}

// interpolation of the CDF at the bin centres c0 + i * step
struct Interp {
  float c0, step;
};
__device__ __forceinline__ Interp make_interp(Lims l) {
  const float step = __fdiv_rn(l.span, (float)kBins);
  return {__fadd_rn(l.vmin, __fmul_rn(0.5f, step)), step};
}
__device__ __forceinline__ float equalised(float x, Interp q,
                                           const float* cdf) {
  float pos = __fdiv_rn(__fsub_rn(x, q.c0), q.step);
  // jnp.clip: NaN stays NaN
  pos = pos < 0.0f ? 0.0f : pos;
  pos = pos > (float)(kBins - 1) ? (float)(kBins - 1) : pos;
  const int i0 = to_index(pos, kBins - 2);
  float f = __fsub_rn(pos, (float)i0);
  f = f < 0.0f ? 0.0f : f;
  f = f > 1.0f ? 1.0f : f;
  return __fadd_rn(__fmul_rn(cdf[i0], __fsub_rn(1.0f, f)),
                   __fmul_rn(cdf[i0 + 1], f));
}

// ---------------------------------------------------------------- cluster

// Calls f(i, v) for the values of vals[0, n) this thread owns: float4 i,
// i + 1, ... at i = 4 * (threadIdx.x + k * kThreads).
template <int kThreads, typename F>
__device__ __forceinline__ void sweep(const float* vals, int n, F&& f) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads) {
    if (i + 4 <= n) {
      const float4 v = *reinterpret_cast<const float4*>(vals + i);
      f(i, v.x);
      f(i + 1, v.y);
      f(i + 2, v.z);
      f(i + 3, v.w);
    } else {
      for (int j = i; j < n; ++j) f(j, vals[j]);
    }
  }
}

template <int kThreads>
struct ClusterSmem {
  int wh[kThreads / 32][kBins];  // per-warp histograms
  int total[kBins];              // rank 0's: the cluster's histogram
  float cdf[kBins];
  float gmin[kMaxCluster], gmax[kMaxCluster];  // the blocks' partials
  int gnan[kMaxCluster];
  float wmin[kThreads / 32], wmax[kThreads / 32];
  int wnan[kThreads / 32], wsum[kBins / 32];
  uint64_t bar;
};

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
histeq_cluster_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int hw, int chunk) {
  constexpr int kWarps = kThreads / 32;
  static_assert(kThreads >= kBins, "one thread a bin");
  extern __shared__ __align__(16) float vals[];
  __shared__ __align__(16) ClusterSmem<kThreads> sm;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), nb = (int)cl.num_blocks();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t start = (size_t)rank * chunk;
  const int n = start >= (size_t)hw ? 0 : min(chunk, hw - (int)start);
  const float* src = x + (size_t)blockIdx.y * hw + start;
  float* dst = out + (size_t)blockIdx.y * hw + start;
  const bool vec = (n & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(dst) & 15) == 0;

  // the part into shared memory, while the histograms are cleared
  if (vec) {
    if (tid == 0) {
      mbar_init(&sm.bar, 1);
      mbar_init_fence();
      mbar_arrive_expect(&sm.bar, (uint32_t)n * 4u);
      if (n > 0) bulk_copy(vals, src, (uint32_t)n * 4u, &sm.bar);
    }
  } else {
    for (int i = tid; i < n; i += kThreads) cp_async4(vals + i, src + i);
    cp_async_commit();
  }
  for (int i = tid; i < kWarps * kBins; i += kThreads) (&sm.wh[0][0])[i] = 0;
  if (tid < kBins) sm.total[tid] = 0;
  if (vec) {
    __syncthreads();  // the barrier's initialisation is visible
    mbar_wait(&sm.bar, 0);
  } else {
    cp_async_wait<0>();
    __syncthreads();
  }

  // min, max and the NaN flag over the cluster
  float lo = INFINITY, hi = -INFINITY;
  int nan = 0;
  sweep<kThreads>(vals, n, [&](int, float v) {
    nan |= isnan(v);
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  });
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
  }
  nan = __reduce_or_sync(kFull, nan);
  if (lane == 0) {
    sm.wmin[warp] = lo;
    sm.wmax[warp] = hi;
    sm.wnan[warp] = nan;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < kWarps ? sm.wmin[lane] : INFINITY;
    hi = lane < kWarps ? sm.wmax[lane] : -INFINITY;
    nan = lane < kWarps ? sm.wnan[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
    }
    nan = __reduce_or_sync(kFull, nan);
    if (lane < nb) {  // lane q stores the block's partial into block q
      cl.map_shared_rank(sm.gmin, lane)[rank] = lo;
      cl.map_shared_rank(sm.gmax, lane)[rank] = hi;
      cl.map_shared_rank(sm.gnan, lane)[rank] = nan;
    }
  }
  cl.sync();
  lo = INFINITY;
  hi = -INFINITY;
  nan = 0;
  for (int q = 0; q < nb; ++q) {
    lo = fminf(lo, sm.gmin[q]);
    hi = fmaxf(hi, sm.gmax[q]);
    nan |= sm.gnan[q];
  }
  const Lims l = make_lims(lo, hi, nan != 0);

  // the histogram: per-warp, then the block's into rank 0's
  int* wh = sm.wh[warp];
  sweep<kThreads>(vals, n,
                  [&](int, float v) { atomicAdd(&wh[bin_of(v, l)], 1); });
  __syncthreads();
  if (tid < kBins) {
    int t = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += sm.wh[w][tid];
    if (t) atomicAdd(cl.map_shared_rank(sm.total, 0) + tid, t);
  }
  cl.sync();

  // the CDF: an inclusive scan of rank 0's histogram, eight warps of 32
  // bins, then each warp adds the totals of the warps before it
  int cum = 0;
  if (tid < kBins) {
    cum = cl.map_shared_rank(sm.total, 0)[tid];
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, cum, o);
      if (lane >= o) cum += v;
    }
    if (lane == 31) sm.wsum[warp] = cum;
  }
  // rank 0's histogram has been read: it may leave once the others have
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();
  if (tid < kBins) {
    int all = 0;
#pragma unroll
    for (int w = 0; w < kBins / 32; ++w) {
      if (w < warp) cum += sm.wsum[w];
      all += sm.wsum[w];
    }
    sm.cdf[tid] = __fdiv_rn((float)cum, (float)all);
  }
  __syncthreads();

  const Interp q = make_interp(l);
  if (vec) {
    for (int i = 4 * tid; i < n; i += 4 * kThreads) {
      const float4 v = *reinterpret_cast<const float4*>(vals + i);
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(equalised(v.x, q, sm.cdf), equalised(v.y, q, sm.cdf),
                      equalised(v.z, q, sm.cdf), equalised(v.w, q, sm.cdf));
    }
  } else {
    sweep<kThreads>(vals, n,
                    [&](int i, float v) { dst[i] = equalised(v, q, sm.cdf); });
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int kThreads>
int launch_cluster(const float* x, float* out, int planes, int hw, int cluster,
                   cudaStream_t stream) {
  auto kernel = histeq_cluster_kernel<kThreads>;
  const int chunk = ((hw + cluster - 1) / cluster + 3) & ~3;
  const size_t smem = (size_t)chunk * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, planes, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (active < 1) return kUnschedulable;
  err = cudaLaunchKernelEx(&cfg, kernel, x, out, hw, chunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- stream

// lims: [P, 3] int = ordered min, ordered max, NaN flag
__device__ __forceinline__ Lims plane_lims(const int* lims, int p) {
  return make_lims(unordered(lims[3 * p]), unordered(lims[3 * p + 1]),
                   lims[3 * p + 2] != 0);
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

// The stream route's in-plane indices are 64-bit: a plane may hold up to
// 2^31 - 1 values, and the loops step up to kStreamBlocks * kStreamThreads
// past its end.
__global__ void __launch_bounds__(kStreamThreads)
minmax_kernel(const float* __restrict__ x, int* __restrict__ lims,
              int64_t hw) {
  const int p = blockIdx.y;
  const float* xp = x + p * hw;
  float lo = INFINITY, hi = -INFINITY;
  int nan = 0;
  for (int64_t i = blockIdx.x * kStreamThreads + threadIdx.x; i < hw;
       i += kStreamBlocks * kStreamThreads) {
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
  __shared__ float slo[kStreamWarps], shi[kStreamWarps];
  __shared__ int snan[kStreamWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    slo[warp] = lo;
    shi[warp] = hi;
    snan[warp] = nan;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kStreamWarps; ++w) {
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

__global__ void __launch_bounds__(kStreamThreads)
hist_kernel(const float* __restrict__ x, const int* __restrict__ lims,
            int* __restrict__ hist, int64_t hw) {
  __shared__ int wh[kStreamWarps][kBins];
  const int p = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kStreamWarps * kBins; i += kStreamThreads)
    (&wh[0][0])[i] = 0;
  __syncthreads();
  const Lims l = plane_lims(lims, p);
  const float* xp = x + p * hw;
  // every lane runs the same number of iterations, so the warp-wide
  // match below sees all 32 lanes; lanes past the end carry bin -1
  const int64_t stride = kStreamBlocks * kStreamThreads;
  const int64_t base = blockIdx.x * kStreamThreads + threadIdx.x - lane;
  for (int64_t i0 = base; i0 < hw; i0 += stride) {
    const int64_t i = i0 + lane;
    const int b = i < hw ? bin_of(__ldg(xp + i), l) : -1;
    const unsigned same = __match_any_sync(kFull, b);
    if (b >= 0 && lane == __ffs(same) - 1)
      atomicAdd(&wh[warp][b], __popc(same));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += kStreamThreads) {
    int t = 0;
    for (int w = 0; w < kStreamWarps; ++w) t += wh[w][b];
    if (t) atomicAdd(hist + (size_t)p * kBins + b, t);
  }
}

__global__ void __launch_bounds__(kStreamThreads)
apply_kernel(const float* __restrict__ x, const int* __restrict__ lims,
             const int* __restrict__ hist, float* __restrict__ out,
             int64_t hw) {
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

  const Interp q = make_interp(plane_lims(lims, p));
  const float* xp = x + p * hw;
  float* op = out + p * hw;
  for (int64_t i = blockIdx.x * kStreamThreads + threadIdx.x; i < hw;
       i += kStreamBlocks * kStreamThreads)
    op[i] = equalised(__ldg(xp + i), q, cdf);
}

int launch_stream(const float* x, float* out, int* lims, int* hist,
                  int planes, int64_t hw, cudaStream_t stream) {
  init_kernel<<<(planes * kBins + kStreamThreads - 1) / kStreamThreads,
                kStreamThreads, 0, stream>>>(lims, hist, planes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(kStreamBlocks, planes);
  minmax_kernel<<<grid, kStreamThreads, 0, stream>>>(x, lims, hw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hist_kernel<<<grid, kStreamThreads, 0, stream>>>(x, lims, hist, hw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_kernel<<<grid, kStreamThreads, 0, stream>>>(x, lims, hist, out, hw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [P, HW] f32 -> out [P, HW] f32 in [0, 1] (NaN on a plane holding a
// NaN).  Cluster route: one cluster of `cluster` blocks of `threads` (512
// or 1024) threads a plane, lims and hist unused.  Stream route: four
// launches with scratch lims [P, 3] int32 and hist [P, 256] int32, planes
// of up to 2^31 - 1 values (a bin's count is an int32).  Returns 0, a CUDA
// error code, or -1 when the cluster cannot be scheduled.
int cy_equalize_hist(const float* x, float* out, int* lims, int* hist,
                     int planes, int64_t hw, int cluster, int threads,
                     int stream_route, cudaStream_t stream) {
  if (planes == 0 || hw == 0) return (int)cudaSuccess;
  if (planes > 65535 || hw > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (stream_route) return launch_stream(x, out, lims, hist, planes, hw, stream);
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  if (threads == 512)
    return launch_cluster<512>(x, out, planes, (int)hw, cluster, stream);
  if (threads == 1024)
    return launch_cluster<1024>(x, out, planes, (int)hw, cluster, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
