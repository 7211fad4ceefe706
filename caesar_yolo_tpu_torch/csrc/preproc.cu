// Fused zscale stretch + masked min/max + min-max normalisation (kernel K3).
//
// Replaces caesar_yolo_tpu/ops/pallas_preproc.py:fused_zscale_minmax
// (_fused_kernel), which holds one 640x640 tile in VMEM and runs the
// README-default chain (zscale, then min-max) in one pass.  The per-tile
// zscale limits (vmin, vmax) come from the sampled line fit outside the
// kernel, as in the reference.  Built with -fmad=false and explicitly
// rounded intrinsics so that every value equals the plain PyTorch chain
// (ops/cuda_preproc.py:zscale_minmax_plain); min/max are exact in any
// order and the rest works pixel by pixel, so splitting a plane changes
// nothing.
//
// Two routes, chosen by the plane's size alone (ops/cuda_preproc.py:plan).
//  - Cluster route, one launch: persistent thread-block clusters of up to
//    16 blocks, as many as can be resident, each walking planes
//    c, c + n, ... (n clusters).  Each block owns one contiguous part of
//    every plane it visits: it bulk-copies the part into shared memory
//    (cp.async.bulk on an mbarrier; 4-byte cp.async where the part is not
//    16-byte aligned), computes the stretch once a pixel in place, reduces
//    the masked min/max of its part and pushes it to every block of the
//    cluster through distributed shared memory; after one cluster barrier
//    each block combines the parts and normalises its part from shared
//    memory, writing float4s.  The part lands in segments, each on its
//    own mbarrier: the stretch starts on the first segment while the rest
//    are in flight, and each segment is refilled with the cluster's next
//    plane as soon as it is normalised.  Each plane is read from device
//    memory once and written once, and the stretch's division runs once a
//    pixel.
//  - Stream route (planes too large for a block's shared memory): three
//    launches spread over kStreamBlocks blocks a plane, reading the plane
//    twice: init (limits), reduce (integer atomic min/max: every valid
//    stretched value lies in (0, 1], where the float order equals the int
//    order of the bit patterns) and apply; float4 loads where aligned.
//
// Bound on an H100: bytes.  Each plane is read once and written once:
// 2*P*HW*4 bytes (105 MB at [32, 640, 640], 31.3 us at 3.35 TB/s); a
// handful of flops a pixel.  32 planes of 1.6 MB exceed the SMs' ~30 MB of
// shared memory, hence the persistent clusters with the next plane's copy
// in flight.  (A second buffer a block, the whole next plane in flight,
// measured slower: one buffer lets two blocks share an SM; PERF.md.)
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

#include <mutex>

#include "async_copy.cuh"
#include "divide.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace acopy;
using namespace divide;

constexpr int kThreads = 512;  // a block of the cluster route
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxSegments = 8;  // bulk copies a plane's part lands in
constexpr int kStreamThreads = 256;
constexpr int kStreamBlocks = 32;  // blocks per plane on the stream route
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnschedulable = -1;

// the stretch of one plane: jnp.clip and the masking convention of
// caesar_yolo_tpu/ops/transforms.py: NaN propagates through the clip
// (comparisons are false), masked input pixels (exactly 0 or non-finite)
// give 0
struct Stretch {
  float vmin;
  Divisor span;
};
__device__ __forceinline__ Stretch make_stretch(float vmin, float vmax) {
  return {vmin, make_divisor(__fsub_rn(vmax, vmin))};
}
__device__ __forceinline__ float zscale_apply(float x, Stretch st) {
  float z = st.span.b != 0.0f ? div_rn(__fsub_rn(x, st.vmin), st.span)
                              : __fsub_rn(x, st.vmin);
  z = z < 0.0f ? 0.0f : z;
  z = z > 1.0f ? 1.0f : z;
  const bool valid_in = x != 0.0f && isfinite(x);
  return valid_in ? z : 0.0f;
}

// z != 0 && isfinite(z) for the stretch's values, which lie in [0, 1] or
// are NaN
__device__ __forceinline__ bool valid_z(float z) { return z > 0.0f; }

// the min-max normalisation of one plane, from its masked (zmin, zmax)
struct Norm {
  float zmin;
  Divisor denom;
  float nspan, nmin;
};
__device__ __forceinline__ Norm make_norm(float zmin, float zmax,
                                          float norm_min, float norm_max) {
  const float zspan = __fsub_rn(zmax, zmin);
  return {zmin, make_divisor(zspan != 0.0f ? zspan : 1.0f),
          __fsub_rn(norm_max, norm_min), norm_min};
}
__device__ __forceinline__ float normalised(float z, Norm n) {
  const bool valid = valid_z(z);
  // a masked pixel's quotient is not kept: divide 0 (fast) in its place
  const float a = valid ? __fsub_rn(z, n.zmin) : 0.0f;
  const float o =
      __fadd_rn(__fmul_rn(div_rn(a, n.denom), n.nspan), n.nmin);
  return valid ? o : 0.0f;
}

__device__ __forceinline__ void take(float z, float& lo, float& hi) {
  if (valid_z(z)) {
    lo = fminf(lo, z);
    hi = fmaxf(hi, z);
  }
}

// ---------------------------------------------------------------- cluster

struct ClusterSmem {
  // the blocks' partials, two sets used by alternate planes: a block can
  // push plane k + 1's partial while another still reads plane k's
  float gmin[2][kMaxCluster], gmax[2][kMaxCluster];
  float wmin[kWarps], wmax[kWarps];
  uint64_t bar[kMaxSegments];  // the segments' bulk copies
};

// The stretch of values [a, b) of buf in place, float4s from a (a multiple
// of 4), folding the valid ones into (lo, hi).
__device__ __forceinline__ void stretch(float* buf, int a, int b,
                                        Stretch st, float& lo, float& hi) {
  for (int i = a + 4 * (int)threadIdx.x; i < b; i += 4 * kThreads) {
    if (i + 4 <= b) {
      float4 v = *reinterpret_cast<float4*>(buf + i);
      v.x = zscale_apply(v.x, st);
      v.y = zscale_apply(v.y, st);
      v.z = zscale_apply(v.z, st);
      v.w = zscale_apply(v.w, st);
      take(v.x, lo, hi);
      take(v.y, lo, hi);
      take(v.z, lo, hi);
      take(v.w, lo, hi);
      *reinterpret_cast<float4*>(buf + i) = v;
    } else {
      for (int j = i; j < b; ++j) {
        buf[j] = zscale_apply(buf[j], st);
        take(buf[j], lo, hi);
      }
    }
  }
}

// The normalisation of values [a, b) of buf into dst, float4s where
// vec (dst 16-byte aligned at a), else floats.
__device__ __forceinline__ void normalise(const float* buf, float* dst,
                                          int a, int b, Norm nm, bool vec) {
  if (vec) {
    for (int i = a + 4 * (int)threadIdx.x; i < b; i += 4 * kThreads) {
      const float4 v = *reinterpret_cast<const float4*>(buf + i);
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(normalised(v.x, nm), normalised(v.y, nm),
                      normalised(v.z, nm), normalised(v.w, nm));
    }
  } else {
    for (int i = a + (int)threadIdx.x; i < b; i += kThreads)
      dst[i] = normalised(buf[i], nm);
  }
}

// One buffer of `chunk` values a block; a plane's part lands in `segs`
// segments of `seg` values (a multiple of 4), each bulk copy counted on
// its own mbarrier, so that the stretch starts on the first segment while
// the rest are in flight, and the next plane's segment j is copied as
// soon as this plane's segment j is normalised.  Where the planes are not
// 16-byte aligned, each thread copies the part with 4-byte cp.async, one
// commit group a plane, once the plane is normalised.
__global__ void __launch_bounds__(kThreads)
zscale_cluster_kernel(const float* __restrict__ x,
                      const float* __restrict__ vlims,
                      float* __restrict__ zlims, float* __restrict__ out,
                      int planes, int hw, int chunk, int segs,
                      float norm_min, float norm_max) {
  extern __shared__ __align__(16) float buf[];  // chunk values
  __shared__ __align__(16) ClusterSmem sm;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), nb = (int)cl.num_blocks();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int first = (int)blockIdx.x / nb, nclusters = (int)gridDim.x / nb;
  const int start = rank * chunk;  // chunk is a multiple of 4
  const int n = start >= hw ? 0 : min(chunk, hw - start);
  const int seg = ((n + segs - 1) / segs + 3) & ~3;
  // every plane's part is 16-byte aligned when the planes are
  const bool vec = (hw & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (vec && tid == 0) {
    for (int j = 0; j < segs; ++j) mbar_init(&sm.bar[j], 1);
    mbar_init_fence();
  }
  cl.sync();  // the barriers are initialised and every block has started
  // thread 0: plane p's segment j
  auto stage_seg = [&](int p, int j) {
    const int a = min(n, j * seg), b = min(n, a + seg);
    mbar_arrive_expect(&sm.bar[j], (uint32_t)(b - a) * 4u);
    if (b > a)
      bulk_copy(buf + a, x + (size_t)p * hw + start + a,
                (uint32_t)(b - a) * 4u, &sm.bar[j]);
  };
  auto stage = [&](int p) {
    if (vec) {
      if (tid == 0)
        for (int j = 0; j < segs; ++j) stage_seg(p, j);
    } else {
      const float* src = x + (size_t)p * hw + start;
      for (int i = tid; i < n; i += kThreads) cp_async4(buf + i, src + i);
      cp_async_commit();
    }
  };

  int p = first;
  if (p < planes) stage(p);
  for (int it = 0; p < planes; p += nclusters, ++it) {
    const int next = p + nclusters;
    if (!vec) {
      cp_async_wait<0>();
      __syncthreads();
    }

    // the stretch, once a pixel, in place, segment by segment as they
    // land; the masked min/max of the part
    const Stretch st = make_stretch(vlims[2 * p], vlims[2 * p + 1]);
    float lo = INFINITY, hi = -INFINITY;
    for (int j = 0; j < segs; ++j) {
      if (vec) mbar_wait(&sm.bar[j], it & 1);
      stretch(buf, min(n, j * seg), min(n, j * seg + seg), st, lo, hi);
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
    }
    if (lane == 0) {
      sm.wmin[warp] = lo;
      sm.wmax[warp] = hi;
    }
    __syncthreads();
    const int set = it & 1;
    if (warp == 0) {
      lo = lane < kWarps ? sm.wmin[lane] : INFINITY;
      hi = lane < kWarps ? sm.wmax[lane] : -INFINITY;
      for (int o = 16; o > 0; o >>= 1) {
        lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
        hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
      }
      if (lane < nb) {  // lane q stores the block's partial into block q
        cl.map_shared_rank(sm.gmin[set], lane)[rank] = lo;
        cl.map_shared_rank(sm.gmax[set], lane)[rank] = hi;
      }
    }
    cl.sync();
    lo = INFINITY;
    hi = -INFINITY;
    for (int q = 0; q < nb; ++q) {
      lo = fminf(lo, sm.gmin[set][q]);
      hi = fmaxf(hi, sm.gmax[set][q]);
    }
    if (rank == 0 && tid == 0) {  // (+inf, -inf) when no pixel is valid
      zlims[2 * p] = lo;
      zlims[2 * p + 1] = hi;
    }

    // the normalisation, from shared memory.  A buffer written by this
    // proxy and refilled by bulk copies: fence both before the next copy.
    const Norm nm = make_norm(lo, hi, norm_min, norm_max);
    float* dst = out + (size_t)p * hw + start;
    for (int j = 0; j < segs; ++j) {
      normalise(buf, dst, min(n, j * seg), min(n, j * seg + seg), nm, vec);
      if (vec) {
        fence_proxy_async();
        __syncthreads();
        if (tid == 0 && next < planes) stage_seg(next, j);
      }
    }
    if (!vec) {
      fence_proxy_async();
      __syncthreads();
      if (next < planes) stage(next);
    }
  }
}

// The clusters of `cluster` blocks with `smem` bytes each that can be
// resident at once (0: none), after setting the kernel's attributes for
// them.  The attributes and the occupancy query cost more host time than
// the kernel takes on small planes, so the last answer is kept by device,
// cluster and shared memory.  Returns a CUDA error code.
int resident_clusters(int cluster, size_t smem, int* active) {
  struct Last {
    int device = -1, cluster = 0, active = 0;
    size_t smem = 0;
  };
  static Last last;
  static std::mutex lock;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> guard(lock);
  if (last.device == device && last.cluster == cluster && last.smem == smem) {
    *active = last.active;
    return (int)cudaSuccess;
  }
  auto kernel = zscale_cluster_kernel;
  // a configuration refused here (too much shared memory) is an error
  // code for the caller, not a sticky error for the next launch
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)cudaGetLastError();
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
  if (err != cudaSuccess) return (int)cudaGetLastError();
  last = {device, cluster, *active, smem};
  return (int)cudaSuccess;
}

int launch_cluster(const float* x, const float* vlims, float* zlims,
                   float* out, int planes, int hw, int cluster, int segs,
                   float norm_min, float norm_max, cudaStream_t stream) {
  const int chunk = ((hw + cluster - 1) / cluster + 3) & ~3;
  const size_t smem = (size_t)chunk * sizeof(float);
  int active = 0;
  const int code = resident_clusters(cluster, smem, &active);
  if (code != (int)cudaSuccess) return code;
  if (active < 1) return kUnschedulable;
  // persistent: as many clusters as can be resident, each walking planes
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * min(planes, active), 1, 1);
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
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, zscale_cluster_kernel, x, vlims,
                         zlims, out, planes, hw, chunk, segs, norm_min,
                         norm_max);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- stream

__global__ void zlims_init_kernel(float* __restrict__ zlims, int planes) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < planes) {
    zlims[2 * p] = INFINITY;
    zlims[2 * p + 1] = -INFINITY;
  }
}

// Calls f(i, v) for the values of xp[0, hw) this block's thread owns on
// the stream route: float4s where the plane is 16-byte aligned, else
// floats.  In-plane indices are 64-bit: a plane may hold up to 2^31 - 1
// values, and the loop steps up to 4 * stride past its end.
template <bool kVec, typename F>
__device__ __forceinline__ void stream_sweep(const float* xp, int64_t hw,
                                             F&& f) {
  const int64_t t = blockIdx.x * kStreamThreads + threadIdx.x;
  constexpr int64_t stride = kStreamBlocks * kStreamThreads;
  if (kVec) {
    for (int64_t i = 4 * t; i < hw; i += 4 * stride) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xp + i));
      f(i, v.x);
      f(i + 1, v.y);
      f(i + 2, v.z);
      f(i + 3, v.w);
    }
  } else {
    for (int64_t i = t; i < hw; i += stride) f(i, __ldg(xp + i));
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kStreamThreads)
reduce_kernel(const float* __restrict__ x, const float* __restrict__ vlims,
              int* __restrict__ zlims, int64_t hw) {
  const int p = blockIdx.y;
  const Stretch st = make_stretch(vlims[2 * p], vlims[2 * p + 1]);
  float lo = INFINITY, hi = -INFINITY;
  stream_sweep<kVec>(x + p * hw, hw, [&](int64_t, float v) {
    take(zscale_apply(v, st), lo, hi);
  });
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
  }
  __shared__ float slo[kStreamThreads / 32], shi[kStreamThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    slo[warp] = lo;
    shi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kStreamThreads / 32; ++w) {
      lo = fminf(lo, slo[w]);
      hi = fmaxf(hi, shi[w]);
    }
    if (lo <= hi) {  // the block saw at least one valid value
      atomicMin(zlims + 2 * p, __float_as_int(lo));
      atomicMax(zlims + 2 * p + 1, __float_as_int(hi));
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kStreamThreads)
apply_kernel(const float* __restrict__ x, const float* __restrict__ vlims,
             const float* __restrict__ zlims, float* __restrict__ out,
             int64_t hw, float norm_min, float norm_max) {
  const int p = blockIdx.y;
  const Stretch st = make_stretch(vlims[2 * p], vlims[2 * p + 1]);
  const Norm nm = make_norm(zlims[2 * p], zlims[2 * p + 1], norm_min,
                            norm_max);
  float* op = out + p * hw;
  stream_sweep<kVec>(x + p * hw, hw, [&](int64_t i, float v) {
    op[i] = normalised(zscale_apply(v, st), nm);
  });
}

template <bool kVec>
int launch_stream(const float* x, const float* vlims, float* zlims,
                  float* out, int planes, int64_t hw, float norm_min,
                  float norm_max, cudaStream_t stream) {
  zlims_init_kernel<<<(planes + kStreamThreads - 1) / kStreamThreads,
                      kStreamThreads, 0, stream>>>(zlims, planes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(kStreamBlocks, planes);
  reduce_kernel<kVec><<<grid, kStreamThreads, 0, stream>>>(
      x, vlims, reinterpret_cast<int*>(zlims), hw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_kernel<kVec><<<grid, kStreamThreads, 0, stream>>>(
      x, vlims, zlims, out, hw, norm_min, norm_max);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [P, HW] f32 planes, vlims [P, 2] f32 zscale limits; zlims [P, 2] f32
// receives the masked (min, max) of the stretched planes ((+inf, -inf)
// where no pixel is valid); out [P, HW] f32.  Cluster route: persistent
// clusters of `cluster` blocks, each holding its part of a plane in shared
// memory, copied in `segments` (1 to 8) bulk copies.
// Stream route: three launches, planes of up to 2^31 - 1 values.  Returns
// 0, a CUDA error code, or -1 when the cluster cannot be scheduled.
int cy_zscale_minmax(const float* x, const float* vlims, float* zlims,
                     float* out, int planes, int64_t hw, float norm_min,
                     float norm_max, int cluster, int segments,
                     int stream_route, cudaStream_t stream) {
  if (planes == 0 || hw == 0) return (int)cudaSuccess;
  if (stream_route) {
    if (planes > 65535) return (int)cudaErrorInvalidValue;
    const bool vec =
        (hw & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    return vec ? launch_stream<true>(x, vlims, zlims, out, planes, hw,
                                     norm_min, norm_max, stream)
               : launch_stream<false>(x, vlims, zlims, out, planes, hw,
                                      norm_min, norm_max, stream);
  }
  if (cluster < 1 || cluster > kMaxCluster || segments < 1 ||
      segments > kMaxSegments || hw > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  return launch_cluster(x, vlims, zlims, out, planes, (int)hw, cluster,
                        segments, norm_min, norm_max, stream);
}

}  // extern "C"
