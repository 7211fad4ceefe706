// Contrast-limited adaptive histogram equalisation of planes (kernel K7).
//
// Replaces caesar_yolo_tpu/ops/pallas_clahe.py:equalize_adapthist_batch
// (_hist_kernel, _blend_kernel): each plane's range, 256-bin histograms of
// the contextual tiles of an 8x8 grid over the reflect-padded plane, 8
// sweeps of clip + redistribution, the CDFs, then every pixel through the
// bilinear blend of its 4 neighbouring tiles' CDFs.  The TPU kernels avoided
// scatter and gather (an occupied-span count loop per tile, a telescoping
// hat-weight sum per pixel); on a GPU both are cheap, so this is the plain
// formulation (caesar_yolo_tpu_torch/ops/clahe.py) in the same order of
// operations, the tables' two sums over 256 bins included (a pairwise tree
// and a lane scan, stated there), built with -fmad=false and explicitly
// rounded intrinsics so that its output equals the plain version bit for
// bit.  Min/max are exact in any order and the counts are integers, so
// neither depends on how the work is split.
//
// Two routes, chosen by the plane's size alone (ops/cuda_clahe.py:plan).
//  - Cluster route, one launch: persistent thread-block clusters of up to
//    16 blocks, as many as can be resident, cluster c taking planes c,
//    c + clusters, ...  Block b holds rows [b * rows, (b + 1) * rows) of
//    each plane: it bulk-copies them into shared memory (cp.async.bulk on
//    an mbarrier; 4-byte cp.async where a row is not a multiple of 16
//    bytes).  Once, at the start, it lays out its rows' and the columns'
//    taps: the tiles each position counts into (a reflect-padded position
//    counts its source pixel again, with no padded copy) and the blend's
//    two tiles and weight, computed once a row and once a column.  For
//    each plane: min, max and the NaN flag go to every block through
//    distributed shared memory, and after a cluster barrier each block
//    holds the plane's range.  It bins each pixel once (into a byte; the
//    division by the span as divide.cuh's div_rn) and counts it into
//    shared histograms of the tile rows its rows touch, and adds those
//    counts into every block whose taps reach those tile rows, through
//    distributed shared memory.  After a second cluster barrier the next
//    plane's copy starts (the values have been read; it lands while this
//    plane is finished), and the block builds the CDFs of the tiles its
//    taps reach from the counts it received (one warp a tile: clip, 8
//    sweeps of redistribution, the scan, the division by the last entry)
//    and blends its pixels from them, writing float4s.  So each plane is
//    read from device memory once and written once, and the tables never
//    leave the chip.
//  - Stream route (planes too large for a cluster's shared memory): four
//    launches: the range (one block a plane), the tile histograms (one
//    block per (tile, plane), per-warp histograms with warp-aggregated
//    atomics), the tables (the cluster route's device code, one warp a
//    tile) and the blend (one thread a pixel, tables in device memory).
//
// Bound on an H100: bytes.  Read each plane once and write it once,
// 2*P*H*W*4 bytes (104.9 MB at [32, 640, 640], ~31 us at 3.35 TB/s).  On
// the cluster route a 640 px plane takes 16 blocks of 40 rows (169 KB of
// shared memory each, one block an SM); 7 clusters are resident, so each
// walks 4 or 5 planes, each copy overlapping the end of the plane before.
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

constexpr int kBins = 256;
constexpr int kLaneBins = kBins / 32;  // a warp holds a tile: 8 bins a lane
constexpr int kSweeps = 8;
constexpr int kMaxCluster = 16;
constexpr int kMaxGrid = 16;
constexpr int kClusterThreads = 1024;  // a block of the cluster route
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kThreads = 256;  // the stream route's hist, tables and blend
constexpr int kWarps = kThreads / 32;
constexpr int kRangeThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnschedulable = -1;
constexpr unsigned kNone = 0xffffu;  // no reflected position

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

// (vmin, span) as ops/clahe.py:value_range gives them: a NaN anywhere
// makes vmin NaN (and span 1, as NaN > NaN is false)
struct Lims {
  float vmin, span;
};
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

// source index of padded position i of an axis of n (reflect at the end)
__device__ __forceinline__ int reflect(int i, int n) {
  return i < n ? i : 2 * (n - 1) - i;
}

struct Tap {
  int t0, t1;
  float f;
};

// the two neighbouring tiles of row (column) i and the second's weight:
// t = (i + 0.5) / tsize - 0.5 on clamped tile coordinates (on the host for
// the launcher's check of the layout: the same IEEE f32 operations)
__host__ __device__ __forceinline__ Tap tap(int i, int tsize, int grid) {
#ifdef __CUDA_ARCH__
  const float c =
      __fsub_rn(__fdiv_rn(__fadd_rn((float)i, 0.5f), (float)tsize), 0.5f);
#else
  const float c = ((float)i + 0.5f) / (float)tsize - 0.5f;
#endif
  float t0 = floorf(c);
  t0 = t0 < 0.0f ? 0.0f : t0;
  t0 = t0 > (float)(grid - 1) ? (float)(grid - 1) : t0;
#ifdef __CUDA_ARCH__
  float f = __fsub_rn(c, t0);
#else
  float f = c - t0;
#endif
  f = f < 0.0f ? 0.0f : f;
  f = f > 1.0f ? 1.0f : f;
  Tap r;
  r.t0 = (int)t0;
  r.t1 = r.t0 + 1 < grid ? r.t0 + 1 : grid - 1;
  r.f = f;
  return r;
}

__device__ __forceinline__ float lerp4(float v00, float v01, float v10,
                                       float v11, float fx, float fy) {
  const float top = __fadd_rn(v00, __fmul_rn(fx, __fsub_rn(v01, v00)));
  const float bot = __fadd_rn(v10, __fmul_rn(fx, __fsub_rn(v11, v10)));
  return __fadd_rn(top, __fmul_rn(fy, __fsub_rn(bot, top)));
}

// One tile's counts -> its CDF, held by a warp, lane l holding bins
// 8l .. 8l + 7 (ops/clahe.py:cdf_tables): 8 sweeps of clip at `limit` and
// redistribution of the excess (a pairwise tree over the 256 bins: three
// levels within the lane, five across lanes by butterfly), then the
// cumulative sum (in order within the lane, a Hillis-Steele scan of the
// lanes' totals, each lane's bins plus the total before it), divided by
// its last entry.
__device__ __forceinline__ void tile_cdf(float (&h)[kLaneBins], float limit) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int s = 0; s < kSweeps; ++s) {
    float a[kLaneBins];
#pragma unroll
    for (int j = 0; j < kLaneBins; ++j)
      a[j] = fmaxf(__fsub_rn(h[j], limit), 0.0f);
    float e = __fadd_rn(
        __fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3])),
        __fadd_rn(__fadd_rn(a[4], a[5]), __fadd_rn(a[6], a[7])));
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
      e = __fadd_rn(e, __shfl_xor_sync(kFull, e, o));
    const float inc = __fmul_rn(e, 1.0f / kBins);  // exact: 2^-8
#pragma unroll
    for (int j = 0; j < kLaneBins; ++j)
      h[j] = __fadd_rn(fminf(h[j], limit), inc);
  }
#pragma unroll
  for (int j = 1; j < kLaneBins; ++j) h[j] = __fadd_rn(h[j - 1], h[j]);
  float t = h[kLaneBins - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, t, o);
    if (lane >= o) t = __fadd_rn(t, u);
  }
  float before = __shfl_up_sync(kFull, t, 1);
  if (lane == 0) before = 0.0f;
#pragma unroll
  for (int j = 0; j < kLaneBins; ++j) h[j] = __fadd_rn(h[j], before);
  const float total = __shfl_sync(kFull, h[kLaneBins - 1], 31);
#pragma unroll
  for (int j = 0; j < kLaneBins; ++j) h[j] = __fdiv_rn(h[j], total);
}

// ---------------------------------------------------------------- cluster

// The planes' geometry and the launch's layout (ops/cuda_clahe.py:layout).
struct Geometry {
  int planes, h, w, grid, th, tw;
  int rows;  // rows a block holds (the last blocks' may be fewer or none)
  int win;   // tile rows a block's count and table buffers hold
  float limit;
};

// The dynamic shared memory of a block, as byte offsets from its start:
// the rows' values, their bins, the counts of the tile rows the block counts
// into (then its tables), the counts the blocks push for its tables, the
// rows' taps, the columns' count offsets, tiles and weights, the rows'
// weights (ops/cuda_clahe.py:layout's byte count must equal `end`: the
// launcher checks it).
struct Carve {
  size_t bins, counts, recv, rowi, colc, colt, colf, rowf, end;
};
__host__ __device__ __forceinline__ Carve carve(const Geometry& g) {
  const size_t values = (size_t)g.rows * g.w, w4 = (size_t)((g.w + 3) & ~3);
  const size_t tiles = (size_t)g.win * g.grid * kBins;
  Carve c;
  c.bins = 4 * ((values + 3) / 4 * 4);
  c.counts = c.bins + (values + 15) / 16 * 16;
  c.recv = c.counts + 4 * tiles;
  c.rowi = c.recv + 4 * tiles;
  c.colc = c.rowi + 16 * (size_t)g.rows;
  c.colt = c.colc + 4 * w4;
  c.colf = c.colt + 4 * w4;
  c.rowf = c.colf + 4 * w4;
  c.end = c.rowf + 4 * (size_t)g.rows;
  return c;
}

struct Smem {
  float gmin[kMaxCluster], gmax[kMaxCluster];  // the blocks' partials
  int gnan[kMaxCluster];
  int ca[kMaxCluster], cb[kMaxCluster];  // each block's table rows
  float wmin[32], wmax[32];
  int wnan[32];
  uint64_t bar;
};

// Adds v to the int that `local` (an address in this block's shared
// memory) names in block `rank` of the cluster, without waiting for it (a
// reduction, not an atomic that returns: the cluster barrier after the
// pushes makes them visible).
__device__ __forceinline__ void red_add(int* local, int rank, int v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(local)), "r"(rank));
  asm volatile("red.shared::cluster.add.u32 [%0], %1;\n" ::"r"(remote),
               "r"(v)
               : "memory");
}

// The rows block `rank` holds, [r0, r0 + nrows).
__host__ __device__ __forceinline__ int block_rows(int rank,
                                                   const Geometry& g,
                                                   int* r0) {
  *r0 = rank * g.rows;
  const int end = g.h < *r0 + g.rows ? g.h : *r0 + g.rows;
  return end > *r0 ? end - *r0 : 0;
}

// The tile rows block `rank` counts into, [ha, hb]: its rows' own, and
// those of the padded positions that reflect onto its rows (the plane's
// last pad rows); and the tile rows its taps reach, [ca, cb].  Both empty
// for a block with no rows.  Each fits in g.win tile rows (the launcher
// checks it; ops/cuda_clahe.py:block_windows).
struct Window {
  int ha, hb, ca, cb;
};
__host__ __device__ __forceinline__ Window block_window(int rank,
                                                        const Geometry& g) {
  int r0 = 0;
  const int nrows = block_rows(rank, g, &r0);
  Window b{0, -1, 0, -1};
  if (nrows == 0) return b;
  const int h = g.h, r1 = r0 + nrows - 1, padh = g.grid * g.th - h;
  b.ha = r0 / g.th;
  b.hb = r1 / g.th;
  const int ylo = r0 > h - 1 - padh ? r0 : h - 1 - padh;
  const int yhi = r1 < h - 2 ? r1 : h - 2;
  if (ylo <= yhi) {
    const int lo = (2 * (h - 1) - yhi) / g.th, hi = (2 * (h - 1) - ylo) / g.th;
    b.ha = lo < b.ha ? lo : b.ha;
    b.hb = hi > b.hb ? hi : b.hb;
  }
  b.ca = tap(r0, g.th, g.grid).t0;
  b.cb = tap(r1, g.th, g.grid).t1;
  return b;
}

// Calls f(y, x) for the items of this block's nrows x (wv items) rows that
// this thread owns: item q = threadIdx.x + k * kClusterThreads at row
// y = q / wv, item x = q % wv, stepped without a division.
template <typename F>
__device__ __forceinline__ void for_items(int nrows, int wv, F&& f) {
  const int nq = nrows * wv;
  int q = threadIdx.x;
  int y = q / wv, x = q - (q / wv) * wv;
  const int dy = kClusterThreads / wv, dx = kClusterThreads - dy * wv;
  for (; q < nq; q += kClusterThreads) {
    f(y, x);
    x += dx;
    y += dy;
    if (x >= wv) {
      x -= wv;
      ++y;
    }
  }
}

// Persistent clusters (grid [cluster * clusters]): cluster c takes planes
// c, c + clusters, ...; block `rank` holds rows [rank * rows, ...) of each.
template <int kVec>
__global__ void __launch_bounds__(kClusterThreads)
clahe_cluster_kernel(const float* __restrict__ x, float* __restrict__ out,
                     Geometry g) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ __align__(16) Smem sm;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), nb = (int)cl.num_blocks();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int first = (int)blockIdx.x / nb, nclusters = (int)gridDim.x / nb;
  const int h = g.h, w = g.w, grid = g.grid;
  int r0 = 0;
  const int nrows = block_rows(rank, g, &r0);
  const int n = nrows * w;
  const int tile_len = grid * kBins;  // a tile row of counts or tables

  const Carve cv = carve(g);
  float* vals = reinterpret_cast<float*>(dyn);
  uint8_t* bins = dyn + cv.bins;
  int* counts = reinterpret_cast<int*>(dyn + cv.counts);
  int* recv = reinterpret_cast<int*>(dyn + cv.recv);
  int4* rowi = reinterpret_cast<int4*>(dyn + cv.rowi);
  int* colc = reinterpret_cast<int*>(dyn + cv.colc);
  int* colt = reinterpret_cast<int*>(dyn + cv.colt);
  float* colf = reinterpret_cast<float*>(dyn + cv.colf);
  float* rowf = reinterpret_cast<float*>(dyn + cv.rowf);
  float* cdf = reinterpret_cast<float*>(counts);

  // the tile rows the block counts into and those its taps reach (every
  // block's, for the pushes)
  const int padh = grid * g.th - h, padw = grid * g.tw - w;
  const Window own = block_window(rank, g);
  const int ha = own.ha, hb = own.hb, ca = own.ca;
  const int ncdf = own.cb - own.ca + 1;
  if (tid < nb) {
    const Window b = block_window(tid, g);
    sm.ca[tid] = b.ca;
    sm.cb[tid] = b.cb;
  }
  for (int i = tid; i < nrows; i += kClusterThreads) {
    const int y = r0 + i;
    const bool refl = y >= h - 1 - padh && y <= h - 2;
    const Tap t = tap(y, g.th, grid);
    rowi[i] = make_int4((y / g.th - ha) * tile_len,
                        refl ? ((2 * (h - 1) - y) / g.th - ha) * tile_len
                             : -1,
                        (t.t0 - ca) * tile_len, (t.t1 - ca) * tile_len);
    rowf[i] = t.f;
  }
  for (int i = tid; i < w; i += kClusterThreads) {
    const bool refl = i >= w - 1 - padw && i <= w - 2;
    const unsigned rx =
        refl ? (unsigned)((2 * (w - 1) - i) / g.tw) * kBins : kNone;
    colc[i] = (int)((unsigned)(i / g.tw) * kBins | rx << 16);
    const Tap t = tap(i, g.tw, grid);
    colt[i] = (int)((unsigned)t.t0 * kBins | (unsigned)t.t1 * kBins << 16);
    colf[i] = t.f;
  }
  for (int i = tid; i < g.win * tile_len; i += kClusterThreads) recv[i] = 0;
  if (kVec && tid == 0) {
    mbar_init(&sm.bar, 1);
    mbar_init_fence();
  }
  // the barrier is initialised, the pushes' targets are clear and every
  // block has started
  cl.sync();

  // plane p's rows into shared memory (a bulk copy counted on the
  // mbarrier, or 4-byte copies, one commit group)
  auto stage = [&](int p) {
    const float* src = x + (size_t)p * h * w + (size_t)r0 * w;
    if constexpr (kVec) {
      if (tid == 0) {
        mbar_arrive_expect(&sm.bar, (uint32_t)n * 4u);
        if (n > 0) bulk_copy(vals, src, (uint32_t)n * 4u, &sm.bar);
      }
    } else {
      for (int i = tid; i < n; i += kClusterThreads)
        cp_async4(vals + i, src + i);
      cp_async_commit();
    }
  };
  if (first < g.planes) stage(first);

  for (int p = first, it = 0; p < g.planes; p += nclusters, ++it) {
    for (int i = tid; i < g.win * tile_len; i += kClusterThreads)
      counts[i] = 0;
    if constexpr (kVec) {
      mbar_wait(&sm.bar, it & 1);
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // min, max and the NaN flag over the cluster
    {
      float lo = INFINITY, hi = -INFINITY;
      int nan = 0;
      if constexpr (kVec) {
        for (int i = 4 * tid; i < n; i += 4 * kClusterThreads) {
          const float4 v = *reinterpret_cast<const float4*>(vals + i);
          nan |= isnan(v.x) | isnan(v.y) | isnan(v.z) | isnan(v.w);
          lo = fminf(fminf(lo, v.x), fminf(v.y, fminf(v.z, v.w)));
          hi = fmaxf(fmaxf(hi, v.x), fmaxf(v.y, fmaxf(v.z, v.w)));
        }
      } else {
        for (int i = tid; i < n; i += kClusterThreads) {
          const float v = vals[i];
          nan |= isnan(v);
          lo = fminf(lo, v);
          hi = fmaxf(hi, v);
        }
      }
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
        lo = lane < kClusterWarps ? sm.wmin[lane] : INFINITY;
        hi = lane < kClusterWarps ? sm.wmax[lane] : -INFINITY;
        nan = lane < kClusterWarps ? sm.wnan[lane] : 0;
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
    }
    cl.sync();
    Lims l;
    {
      float lo = INFINITY, hi = -INFINITY;
      int nan = 0;
      for (int q = 0; q < nb; ++q) {
        lo = fminf(lo, sm.gmin[q]);
        hi = fmaxf(hi, sm.gmax[q]);
        nan |= sm.gnan[q];
      }
      l = make_lims(lo, hi, nan != 0);
    }
    const Divisor span = make_divisor(l.span);

    // each pixel binned once and counted at every padded position it takes
    auto bin = [&](float v) {
      return to_index(__fmul_rn(div_rn(__fsub_rn(v, l.vmin), span),
                                (float)kBins),
                      kBins - 1);
    };
    auto count = [&](int4 ri, int c, int b) {
      const int cx = c & 0xffff, rx = (int)((unsigned)c >> 16);
      atomicAdd(counts + ri.x + cx + b, 1);
      if (rx != (int)kNone) atomicAdd(counts + ri.x + rx + b, 1);
      if (ri.y >= 0) {
        atomicAdd(counts + ri.y + cx + b, 1);
        if (rx != (int)kNone) atomicAdd(counts + ri.y + rx + b, 1);
      }
    };
    if constexpr (kVec) {
      for_items(nrows, w >> 2, [&](int y, int xq) {
        const int i = y * w + 4 * xq;
        const float4 v = *reinterpret_cast<const float4*>(vals + i);
        const int b0 = bin(v.x), b1 = bin(v.y), b2 = bin(v.z), b3 = bin(v.w);
        *reinterpret_cast<uchar4*>(bins + i) = make_uchar4(b0, b1, b2, b3);
        const int4 ri = rowi[y];
        const int4 c = *reinterpret_cast<const int4*>(colc + 4 * xq);
        count(ri, c.x, b0);
        count(ri, c.y, b1);
        count(ri, c.z, b2);
        count(ri, c.w, b3);
      });
    } else {
      for_items(nrows, w, [&](int y, int xx) {
        const int i = y * w + xx;
        const int b = bin(vals[i]);
        bins[i] = (uint8_t)b;
        count(rowi[y], colc[xx], b);
      });
    }
    // the values have been read (a buffer read by this proxy and refilled
    // by bulk copies: fence before the next copy, which is issued after the
    // second cluster barrier)
    fence_proxy_async();
    __syncthreads();

    // the counts into every block whose taps reach their tile rows
    for (int i = tid; i < (hb - ha + 1) * tile_len; i += kClusterThreads) {
      const int c = counts[i];
      if (c) {
        const int k = ha + i / tile_len, at = i - (i / tile_len) * tile_len;
        for (int q = 0; q < nb; ++q)
          if (sm.ca[q] <= k && k <= sm.cb[q])
            red_add(recv + (k - sm.ca[q]) * tile_len + at, q, c);
      }
    }
    cl.sync();
    // the next plane's rows land while this one is finished
    if (p + nclusters < g.planes) stage(p + nclusters);

    // the tables of the tile rows the block's taps reach, one warp a tile,
    // from the pushed counts (cleared for the next plane once read) into
    // the buffer of its own counts, which have been pushed
    for (int k = warp; k < ncdf * grid; k += kClusterWarps) {
      int4* c = reinterpret_cast<int4*>(recv + k * kBins + kLaneBins * lane);
      const int4 c0 = c[0], c1 = c[1];
      c[0] = c[1] = make_int4(0, 0, 0, 0);
      float v[kLaneBins] = {(float)c0.x, (float)c0.y, (float)c0.z,
                            (float)c0.w, (float)c1.x, (float)c1.y,
                            (float)c1.z, (float)c1.w};
      tile_cdf(v, g.limit);
      float4* o =
          reinterpret_cast<float4*>(cdf + k * kBins + kLaneBins * lane);
      o[0] = make_float4(v[0], v[1], v[2], v[3]);
      o[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    __syncthreads();

    // the blend, from shared memory
    float* dst = out + (size_t)p * h * w + (size_t)r0 * w;
    auto blend1 = [&](int4 ri, float fy, int ct, float fx, int b) {
      const int c0 = ct & 0xffff, c1 = (int)((unsigned)ct >> 16);
      return lerp4(cdf[ri.z + c0 + b], cdf[ri.z + c1 + b],
                   cdf[ri.w + c0 + b], cdf[ri.w + c1 + b], fx, fy);
    };
    if constexpr (kVec) {
      for_items(nrows, w >> 2, [&](int y, int xq) {
        const int i = y * w + 4 * xq;
        const uchar4 b = *reinterpret_cast<const uchar4*>(bins + i);
        const int4 ri = rowi[y];
        const float fy = rowf[y];
        const int4 ct = *reinterpret_cast<const int4*>(colt + 4 * xq);
        const float4 fx = *reinterpret_cast<const float4*>(colf + 4 * xq);
        *reinterpret_cast<float4*>(dst + i) = make_float4(
            blend1(ri, fy, ct.x, fx.x, b.x), blend1(ri, fy, ct.y, fx.y, b.y),
            blend1(ri, fy, ct.z, fx.z, b.z), blend1(ri, fy, ct.w, fx.w, b.w));
      });
    } else {
      for_items(nrows, w, [&](int y, int xx) {
        const int i = y * w + xx;
        dst[i] = blend1(rowi[y], rowf[y], colt[xx], colf[xx], bins[i]);
      });
    }
    __syncthreads();  // the tables are read before the next plane's counts
  }
}

// The clusters of `cluster` blocks with `smem` bytes each that can be
// resident at once (0: none), after setting the kernel's attributes for
// them.  The attributes and the occupancy query cost more host time than
// the kernel takes on small planes, so the last answer is kept by device,
// kernel, cluster and shared memory.  Returns a CUDA error code.
template <typename Kernel>
int resident_clusters(Kernel kernel, int cluster, size_t smem, int* active) {
  struct Last {
    int device = -1, cluster = 0, active = 0;
    const void* kernel = nullptr;
    size_t smem = 0;
  };
  static Last last;
  static std::mutex lock;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> guard(lock);
  const void* key = reinterpret_cast<const void*>(kernel);
  if (last.device == device && last.kernel == key &&
      last.cluster == cluster && last.smem == smem) {
    *active = last.active;
    return (int)cudaSuccess;
  }
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
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
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
  last = {device, cluster, *active, key, smem};
  return (int)cudaSuccess;
}

template <int kVec>
int launch_cluster(const float* x, float* out, const Geometry& g,
                   int cluster, cudaStream_t stream) {
  auto kernel = clahe_cluster_kernel<kVec>;
  const size_t smem = carve(g).end;
  int active = 0;
  const int code = resident_clusters(kernel, cluster, smem, &active);
  if (code != (int)cudaSuccess) return code;
  if (active < 1) return kUnschedulable;
  // persistent: as many clusters as can be resident, each walking planes
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * min(g.planes, active), 1, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, out, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- stream

// lims [2P]: vmin of each plane, then its span; one block a plane
__global__ void __launch_bounds__(kRangeThreads)
range_kernel(const float* __restrict__ x, float* __restrict__ lims, int hw,
             int planes) {
  constexpr int kW = kRangeThreads / 32;
  __shared__ float slo[kW], shi[kW];
  __shared__ int snan[kW];
  const int p = blockIdx.x;
  const float* xp = x + (size_t)p * hw;
  float lo = INFINITY, hi = -INFINITY;
  int nan = 0;
  for (int i = threadIdx.x; i < hw; i += kRangeThreads) {
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
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    slo[warp] = lo;
    shi[warp] = hi;
    snan[warp] = nan;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int v = 1; v < kW; ++v) {
      lo = fminf(lo, slo[v]);
      hi = fmaxf(hi, shi[v]);
      nan |= snan[v];
    }
    const Lims l = make_lims(lo, hi, nan != 0);
    lims[p] = l.vmin;
    lims[planes + p] = l.span;
  }
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

// counts [tiles, 256] f32 -> CDFs in place, one warp a tile
__global__ void __launch_bounds__(kThreads)
tables_kernel(float* __restrict__ tab, int tiles, float limit) {
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t >= tiles) return;  // a whole warp leaves
  float4* p = reinterpret_cast<float4*>(tab + (size_t)t * kBins +
                                        kLaneBins * (threadIdx.x & 31));
  const float4 a = p[0], b = p[1];
  float v[kLaneBins] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  tile_cdf(v, limit);
  p[0] = make_float4(v[0], v[1], v[2], v[3]);
  p[1] = make_float4(v[4], v[5], v[6], v[7]);
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
  out[at] = lerp4(__ldg(tab + (ty.t0 * grid + tx.t0) * kBins),
                  __ldg(tab + (ty.t0 * grid + tx.t1) * kBins),
                  __ldg(tab + (ty.t1 * grid + tx.t0) * kBins),
                  __ldg(tab + (ty.t1 * grid + tx.t1) * kBins), tx.f, ty.f);
}

int launch_hist(const float* x, const float* vmin, const float* span,
                float* hist, int planes, int h, int w, int grid, int th,
                int tw, cudaStream_t stream) {
  hist_kernel<<<dim3(grid * grid, planes), kThreads, 0, stream>>>(
      x, vmin, span, hist, h, w, grid, th, tw);
  return (int)cudaGetLastError();
}

int launch_blend(const float* x, const float* vmin, const float* span,
                 const float* cdf, float* out, int planes, int h, int w,
                 int grid, int th, int tw, cudaStream_t stream) {
  blend_kernel<<<dim3((h * w + kThreads - 1) / kThreads, planes), kThreads,
                 0, stream>>>(x, vmin, span, cdf, out, h, w, grid, th, tw);
  return (int)cudaGetLastError();
}

// scratch: tables [P, grid*grid, 256], then lims [2P]
int launch_stream(const float* x, float* out, float* scratch,
                  const Geometry& g, cudaStream_t stream) {
  const int planes = g.planes;
  float* tab = scratch;
  float* lims = scratch + (size_t)planes * g.grid * g.grid * kBins;
  range_kernel<<<planes, kRangeThreads, 0, stream>>>(x, lims, g.h * g.w,
                                                     planes);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = launch_hist(x, lims, lims + planes, tab, planes, g.h, g.w, g.grid,
                    g.th, g.tw, stream);
  if (err) return err;
  const int tiles = planes * g.grid * g.grid;
  tables_kernel<<<(tiles + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      tab, tiles, g.limit);
  err = (int)cudaGetLastError();
  if (err) return err;
  return launch_blend(x, lims, lims + planes, tab, out, planes, g.h, g.w,
                      g.grid, g.th, g.tw, stream);
}

}  // namespace

extern "C" {

// x [P, H, W] f32 -> out [P, H, W] f32: CLAHE of each plane with grid x
// grid contextual tiles of th x tw and the clip limit in counts.  Cluster
// route: persistent clusters of `cluster` blocks of 1024 threads, each
// walking planes, each block holding `rows` rows of a plane and `win` tile
// rows of counts and of tables in `smem` bytes of shared memory (the
// caller's layout: `win` must be the widest block's window and `smem` the
// kernel's carving, else the call is refused), `vec` when W is a multiple
// of 4 and x and out are 16-byte aligned; scratch unused.  Stream route:
// four launches with scratch [P*grid*grid*256 + 2P] f32.  Returns 0, a
// CUDA error code, or -1 when the cluster cannot be scheduled.
int cy_clahe(const float* x, float* out, float* scratch, int planes, int h,
             int w, int grid, int th, int tw, float limit, int cluster,
             int rows, int win, int smem, int vec, int stream_route,
             cudaStream_t stream) {
  if (planes == 0 || h * w == 0) return (int)cudaSuccess;
  if (planes > 65535 || grid < 1 || grid > kMaxGrid)
    return (int)cudaErrorInvalidValue;
  const Geometry g{planes, h, w, grid, th, tw, rows, win, limit};
  if (stream_route) return launch_stream(x, out, scratch, g, stream);
  if (cluster < 1 || cluster > kMaxCluster || rows * cluster < h ||
      win < 1 || win > grid || (vec && (w & 3)) ||
      carve(g).end != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  int widest = 0;
  for (int q = 0; q < cluster; ++q) {
    const Window b = block_window(q, g);
    const int need = 1 + (b.hb - b.ha > b.cb - b.ca ? b.hb - b.ha
                                                    : b.cb - b.ca);
    widest = need > widest ? need : widest;
  }
  if (widest != win) return (int)cudaErrorInvalidValue;
  return vec ? launch_cluster<1>(x, out, g, cluster, stream)
             : launch_cluster<0>(x, out, g, cluster, stream);
}

// The stream route's histogram and blend kernels, each launched on its
// own (with the range from the caller, not the route's range launch).
// x [P, H, W] f32, vmin/span [P] f32 -> hist [P, grid*grid, 256] f32
// counts of the contextual tiles (th x tw each) of the reflect-padded plane.
int cy_clahe_hist(const float* x, const float* vmin, const float* span,
                  float* hist, int planes, int h, int w, int grid, int th,
                  int tw, cudaStream_t stream) {
  if (planes == 0) return (int)cudaSuccess;
  return launch_hist(x, vmin, span, hist, planes, h, w, grid, th, tw,
                     stream);
}

// x [P, H, W] f32, vmin/span [P], cdf [P, grid*grid, 256] f32 -> out
// [P, H, W] f32, each pixel the blend of its 4 neighbouring tiles' CDFs.
int cy_clahe_blend(const float* x, const float* vmin, const float* span,
                   const float* cdf, float* out, int planes, int h, int w,
                   int grid, int th, int tw, cudaStream_t stream) {
  if (planes == 0 || h * w == 0) return (int)cudaSuccess;
  return launch_blend(x, vmin, span, cdf, out, planes, h, w, grid, th, tw,
                      stream);
}

}  // extern "C"
