// Sigma-clipped statistics of masked planes (kernel K5).
//
// Replaces caesar_yolo_tpu/ops/pallas_stats.py:sigma_clipped_stats_batch
// (_sigma_clip_kernel), which holds one tile in VMEM and runs the whole
// astropy clip loop on it: 5 iterations, each a 24-round value-domain
// bisection for the two middle order statistics (k2's bracket shares
// k1's until they split) with an exact pin, plus masked moments; the
// kept set is the intersection of every iteration's bounds.  Same
// arithmetic as the plain version (caesar_yolo_tpu_torch/ops/stats.py),
// built with -fmad=false and explicitly rounded intrinsics, so the
// bisection brackets, and with them the medians, equal it bit for bit
// wherever the kept sets agree.
//
// The mask is derived from the values (finite and != 0), as all callers
// pass valid_mask of the values they pass: the kernel reads the f32
// plane only.
//
// Design.  One thread-block cluster per plane (grid [cluster, planes]);
// each block owns a contiguous part of the plane.
//  - Cluster route: the block copies its part into shared memory once
//    (a 512x512 plane is 1 MB: 64 KB a block over 16 blocks).  Stream
//    route (planes of more than 16 x 53248 values, chosen by size alone
//    in ops/cuda_stats.py): every pass reads the part from device
//    memory, with the same arithmetic.
//  - Each pass ends in one reduction: within the warp, then the block
//    (warp partials in warp order), then the cluster: warp 0 stores the
//    block's partial into slot `rank` of every block's gather array
//    through distributed shared memory, and after one cluster barrier
//    each block adds its gather array in rank order.  The arrays are
//    double-buffered by pass parity, so that barrier is the only one a
//    pass needs.  Integer counts, exact min/max, and the moments summed in
//    f64 (squares exact) in a fixed order, the mean and variance taken in
//    f64 and each rounded once to f32, as the plain version does: the sums'
//    orders differ by f64 roundings only, far below an f32 ulp, so the
//    bounds med +- sigma * std, and with them the kept sets, are the plain
//    version's.  Two calls give bit-equal statistics; no float atomics.
//  - Four bisection rounds a pass.  A round's midpoint depends only on
//    its bracket, so the midpoints of four rounds form a 15-node tree,
//    built with the round's own f32 operations.  One sweep buckets the
//    values in the bracket by the number of midpoints below them (a
//    4-step search, four values interleaved; counts packed in 8-bit
//    register fields); the counts at each node, plus the known count
//    below the bracket, decide the four rounds exactly as the binary
//    search would, collapsing brackets included.  Where the tree is not
//    ordered inside its bracket (an f32 overflow of lo + hi) the sweep
//    counts every midpoint directly.  24 rounds take 6 passes.
//  - The first pass also takes the moments.  Kept sets only shrink and
//    every stats_of starts from the same bracket (lo0, vmax], so a later
//    stats_of's first pass counts only the values its kept set lost and
//    takes them from the previous counts; the cluster route stores xm
//    back into shared memory, a dropped value as +inf.  When nothing was
//    lost, every later stats_of would repeat the last: the loop stops.
//  - The pin is one pass: the smallest and next distinct values in each
//    bracket and the multiplicity of the smallest, merged exactly; with
//    the count below the bracket that gives the count at the smallest
//    member without a second pass.
// So a plane takes at most 1 + 6 x (6 + 1) = 43 passes (the one-block-
// per-plane design before it took 163, each re-read from L2, on 1 SM).
//
// Bound on an H100: read each plane once, P*H*W*4 bytes (32 MB at
// [32, 512, 512], ~10 us at 3.35 TB/s).  The kernel is bound instead by
// the sweeps' instructions and each pass's reduction and barrier
// latencies; 32 planes of 1 MB take two waves, as the SMs' shared
// memory holds 30 MB.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRounds = 24;
constexpr int kLevels = 4;             // bisection rounds a pass
constexpr int kBins = 1 << kLevels;    // 15 midpoints, 16 buckets
constexpr int kPasses = kRounds / kLevels;
constexpr int kMaxWarps = 32;
constexpr int kMaxCluster = 16;
constexpr int kNi = 1 + 2 * kBins;     // a count, then two histograms
constexpr int kNf = 4;
constexpr int kNd = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnschedulable = -1;

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

// one bisection round's midpoint (ops/stats.py: 0.5 * (lo + hi))
__device__ __forceinline__ float midpoint(float lo, float hi) {
  return __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

// A pass's partial: a count and two 16-bucket histograms (int), four
// floats (min/max, or the pin's values) and two doubles (the moments).
struct Slot {
  int i[kNi];
  float f[kNf];
  double d[kNd];
};

enum FloatOp { kMin, kMax };

// The clip loop's state, kept by thread 0 of each block (every block of a
// cluster computes the same values from the same reduced partials) and
// read by all threads after the pass's closing barrier.
struct State {
  float mid[2][kBins];  // each bracket's 15 tree midpoints, in order
  float lo[2], hi[2];   // bisection brackets (lo, hi]
  int clo[2];           // count(xm <= lo)
  int k[2];             // the order statistics sought (1-based)
  int shared;           // both brackets are the same: one histogram
  int direct[2];        // the tree is not ordered: count each midpoint
  float lo_acc, up_acc, lower, upper, lo0, vmax;
  float prev_lo, prev_up;  // the previous stats_of's kept bounds
  int hist0[kBins];        // first pass's counts over the previous kept set
  int nv, n, prev_n;
  int converged;           // the kept set did not change: nothing will
  float mean, var, med;
};

struct Smem {
  Slot warp[kMaxWarps];
  Slot gather[2][kMaxCluster];  // the blocks' partials, by pass parity
  Slot res;                     // the cluster's reduced partial
  State st;
};

// Where this block's values are: shared memory (cluster route) or device
// memory (stream route).
struct Part {
  const float* g;
  float* s;
  int n;
  bool vec4;
};

// Values 4q .. 4q+3 of the block's part (those from lim on are absent).
template <bool kStream>
__device__ __forceinline__ float4 load4(const Part& part, int q, int lim) {
  if (!kStream) return reinterpret_cast<const float4*>(part.s)[q];
  if (part.vec4) return __ldg(reinterpret_cast<const float4*>(part.g) + q);
  const float* p = part.g + 4 * q;
  return make_float4(__ldg(p), lim > 1 ? __ldg(p + 1) : 0.0f,
                     lim > 2 ? __ldg(p + 2) : 0.0f, lim > 3 ? __ldg(p + 3) : 0.0f);
}

// Calls f(v) for every value of the block's part owned by this thread,
// in a fixed order per thread.
template <bool kStream, int kThreads, typename F>
__device__ __forceinline__ void sweep(const Part& part, F&& f) {
  const int nq = (part.n + 3) >> 2;
  for (int q = threadIdx.x; q < nq; q += kThreads) {
    const int lim = part.n - 4 * q;
    const float4 v = load4<kStream>(part, q, lim);
    f(v.x);
    if (lim > 1) f(v.y);
    if (lim > 2) f(v.z);
    if (lim > 3) f(v.w);
  }
}

__device__ __forceinline__ double warp_sum(double v) {
  // butterfly: every lane adds the same two values, so all lanes agree
  for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float apply(FloatOp op, float a, float b) {
  return op == kMin ? fminf(a, b) : fmaxf(a, b);
}

// The pin's merge of (smallest, its multiplicity, next distinct) triples:
// exact, so the order of merging does not matter.
struct Pin {
  float m1, m2;
  int c;
};
__device__ __forceinline__ Pin merge(Pin a, Pin b) {
  if (a.m1 < b.m1) return {a.m1, fminf(a.m2, b.m1), a.c};
  if (b.m1 < a.m1) return {b.m1, fminf(b.m2, a.m1), b.c};
  return {a.m1, fminf(a.m2, b.m2), a.c + b.c};
}
__device__ __forceinline__ Pin warp_pin(Pin p) {
  for (int o = 16; o > 0; o >>= 1) {
    Pin q{__shfl_xor_sync(kFull, p.m1, o), __shfl_xor_sync(kFull, p.m2, o),
          __shfl_xor_sync(kFull, p.c, o)};
    p = merge(p, q);
  }
  return p;
}

// Reduces the warps' partials in sm.warp over the block, then the blocks'
// over the cluster, into sm.res; then thread 0 runs post(sm.st, sm.res)
// and the block synchronises.  pin: slots hold two Pin triples (f[0..1]
// and i[0] for bracket 0, f[2..3] and i[1] for bracket 1); otherwise the
// first ni ints add, the first nf floats reduce by ops[j] and the first nd
// doubles add.  Lane e of warp 0 takes element e: it combines the warps'
// partials in warp order,
// stores the block's into slot `rank` of every block's gather array
// (distributed shared memory), and after the cluster barrier combines
// its own gather array in rank order, so every block gets the same sums.
template <int kThreads, typename Post>
__device__ __forceinline__ void reduce(Smem& sm, cg::cluster_group& cl,
                                       int& parity, bool pin, int ni, int nf,
                                       int nd, const FloatOp (&ops)[kNf],
                                       Post&& post) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  __syncthreads();
  Slot* gather = sm.gather[parity];
  if (warp == 0) {
    if (pin) {
      if (lane < 2) {
        Pin acc{sm.warp[0].f[2 * lane], sm.warp[0].f[2 * lane + 1],
                sm.warp[0].i[lane]};
        for (int w = 1; w < kWarps; ++w)
          acc = merge(acc, {sm.warp[w].f[2 * lane], sm.warp[w].f[2 * lane + 1],
                            sm.warp[w].i[lane]});
        for (int q = 0; q < nb; ++q) {
          Slot* dst = cl.map_shared_rank(gather + rank, q);
          dst->f[2 * lane] = acc.m1;
          dst->f[2 * lane + 1] = acc.m2;
          dst->i[lane] = acc.c;
        }
      }
    } else {
      for (int e = lane; e < ni + nf + nd; e += 32) {
        if (e < ni) {
          int t = 0;
          for (int w = 0; w < kWarps; ++w) t += sm.warp[w].i[e];
          for (int q = 0; q < nb; ++q) cl.map_shared_rank(gather + rank, q)->i[e] = t;
        } else if (e < ni + nf) {
          const int j = e - ni;
          float t = sm.warp[0].f[j];
          for (int w = 1; w < kWarps; ++w) t = apply(ops[j], t, sm.warp[w].f[j]);
          for (int q = 0; q < nb; ++q) cl.map_shared_rank(gather + rank, q)->f[j] = t;
        } else {
          const int j = e - ni - nf;
          double t = sm.warp[0].d[j];
          for (int w = 1; w < kWarps; ++w) t = __dadd_rn(t, sm.warp[w].d[j]);
          for (int q = 0; q < nb; ++q) cl.map_shared_rank(gather + rank, q)->d[j] = t;
        }
      }
    }
  }
  cl.sync();
  if (warp == 0) {
    if (pin) {
      if (lane < 2) {
        Pin acc{gather[0].f[2 * lane], gather[0].f[2 * lane + 1], gather[0].i[lane]};
        for (int q = 1; q < nb; ++q)
          acc = merge(acc, {gather[q].f[2 * lane], gather[q].f[2 * lane + 1],
                            gather[q].i[lane]});
        sm.res.f[2 * lane] = acc.m1;
        sm.res.f[2 * lane + 1] = acc.m2;
        sm.res.i[lane] = acc.c;
      }
    } else {
      for (int e = lane; e < ni + nf + nd; e += 32) {
        if (e < ni) {
          int t = 0;
          for (int q = 0; q < nb; ++q) t += gather[q].i[e];
          sm.res.i[e] = t;
        } else if (e < ni + nf) {
          const int j = e - ni;
          float t = gather[0].f[j];
          for (int q = 1; q < nb; ++q) t = apply(ops[j], t, gather[q].f[j]);
          sm.res.f[j] = t;
        } else {
          const int j = e - ni - nf;
          double t = gather[0].d[j];
          for (int q = 1; q < nb; ++q) t = __dadd_rn(t, gather[q].d[j]);
          sm.res.d[j] = t;
        }
      }
    }
    __syncwarp();
    if (lane == 0) post(sm.st, sm.res);
  }
  parity ^= 1;
  __syncthreads();
}

// The 15 midpoints of four rounds from bracket (lo, hi], in order (node 7
// is round 1's, nodes 3 and 11 round 2's after going low or high, ...),
// into out; returns lo <= m[0] <= ... <= m[14] <= hi (false on NaN), when
// a value in (lo, hi] is <= m[j] exactly when fewer than j + 1 midpoints
// lie below it.  Built in registers, stored once.
__device__ bool build_tree(float lo, float hi, float* out) {
  float m[kBins];
  m[7] = midpoint(lo, hi);
  m[3] = midpoint(lo, m[7]);
  m[11] = midpoint(m[7], hi);
  m[1] = midpoint(lo, m[3]);
  m[5] = midpoint(m[3], m[7]);
  m[9] = midpoint(m[7], m[11]);
  m[13] = midpoint(m[11], hi);
  m[0] = midpoint(lo, m[1]);
  m[2] = midpoint(m[1], m[3]);
  m[4] = midpoint(m[3], m[5]);
  m[6] = midpoint(m[5], m[7]);
  m[8] = midpoint(m[7], m[9]);
  m[10] = midpoint(m[9], m[11]);
  m[12] = midpoint(m[11], m[13]);
  m[14] = midpoint(m[13], hi);
  m[15] = INFINITY;
  bool ok = lo <= m[0] && m[kBins - 2] <= hi;
#pragma unroll
  for (int j = 0; j < kBins; ++j) {
    if (j + 1 < kBins - 1) ok = ok && m[j] <= m[j + 1];
    out[j] = m[j];
  }
  return ok;
}

// Thread 0: the next pass's trees from the current brackets.
__device__ void plan_trees(State& st) {
  const float lo0 = st.lo[0], hi0 = st.hi[0], lo1 = st.lo[1], hi1 = st.hi[1];
  const bool shared = __float_as_int(lo0) == __float_as_int(lo1) &&
                      __float_as_int(hi0) == __float_as_int(hi1);
  st.shared = shared;
  const bool d0 = !build_tree(lo0, hi0, st.mid[0]);
  st.direct[0] = d0;
  st.direct[1] = shared ? d0 : !build_tree(lo1, hi1, st.mid[1]);
}

// Thread 0: four rounds of each bracket's binary search, from the counts
// of the pass (histogram h of values in the bracket by the number of
// midpoints below them, or, for a direct tree, count(xm <= m[j])).
__device__ void walk(State& st, const Slot& res) {
  const bool shared = st.shared;
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const int t = shared ? 0 : b;
    const int* h = res.i + 1 + kBins * t;
    const bool direct = st.direct[t];
    const float* mid = st.mid[t];
    float lo = st.lo[b], hi = st.hi[b];
    int clo = st.clo[b];
    const int k = st.k[b];
    int c[kBins - 1];
    int acc = clo;
#pragma unroll
    for (int j = 0; j < kBins - 1; ++j) {
      const int hj = h[j];
      acc += hj;
      c[j] = direct ? hj : acc;
    }
    int node = kBins / 2 - 1;
#pragma unroll
    for (int level = 0; level < kLevels; ++level) {
      const int step = (kBins / 4) >> level;
      int cn = 0;
#pragma unroll
      for (int j = 0; j < kBins - 1; ++j)
        if (j == node) cn = c[j];
      const float m = mid[node];
      if (cn >= k) {
        hi = m;
        node -= step;
      } else {
        lo = m;
        clo = cn;
        node += step;
      }
    }
    st.lo[b] = lo;
    st.hi[b] = hi;
    st.clo[b] = clo;
  }
}

// The number of the ordered midpoints m[0..14] below each of four values
// (m[15] = +inf): a 4-step search, the four values' loads interleaved.
__device__ __forceinline__ void bucket4(const float* m, const float (&x)[4],
                                        int (&r)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) r[e] = 0;
#pragma unroll
  for (int step = kBins / 2; step > 0; step >>= 1) {
    float probe[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) probe[e] = m[r[e] + step - 1];
#pragma unroll
    for (int e = 0; e < 4; ++e) r[e] += probe[e] < x[e] ? step : 0;
  }
}

// Adds one to 8-bit field r of the four words w (bucket r's count).
__device__ __forceinline__ void add_bucket(unsigned (&w)[4], int r, bool on) {
  const unsigned inc = on ? 1u << ((r & 3) << 3) : 0u;
  const int q = r >> 2;
  w[0] += q == 0 ? inc : 0u;
  w[1] += q == 1 ? inc : 0u;
  w[2] += q == 2 ? inc : 0u;
  w[3] += q == 3 ? inc : 0u;
}

// Adds the warp's packed bucket counts to its slot and clears them: the
// 8-bit fields 0, 2 and 1, 3 of each word widened to 16 bits and summed
// over the warp (at most 32 * 255 each), then lane 16 b + j adds bracket
// b's bucket j.
__device__ __forceinline__ void flush_hist(unsigned (&w)[2][4], int nb,
                                           Slot& slot) {
  const int lane = threadIdx.x & 31;
  unsigned s[2][2][4];
#pragma unroll
  for (int b = 0; b < 2; ++b) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s[b][0][q] = b < nb ? __reduce_add_sync(kFull, w[b][q] & 0x00ff00ffu) : 0u;
      s[b][1][q] =
          b < nb ? __reduce_add_sync(kFull, (w[b][q] >> 8) & 0x00ff00ffu) : 0u;
      w[b][q] = 0u;
    }
  }
  const int b = lane >> 4, j = lane & 15, q = j >> 2, odd = j & 1;
  unsigned v = 0u;
#pragma unroll
  for (int bb = 0; bb < 2; ++bb)
#pragma unroll
    for (int qq = 0; qq < 4; ++qq)
      if (bb == b && qq == q) v = odd ? s[bb][1][qq] : s[bb][0][qq];
  const int add = (int)((j & 2) ? v >> 16 : v & 0xffffu);
  if (b < nb) slot.i[1 + kBins * b + j] += add;
}

// The kept set's test on a value as the pass reads it.  The stream route
// reads the planes as given.  The cluster route stores each stats_of's xm
// back into shared memory on its first pass (kept sets only shrink, as the
// bounds only tighten), so later stats_of's first passes find +inf where
// a value was dropped, and their other passes read xm as stored.
template <bool kStream>
__device__ __forceinline__ bool kept(float v, bool raw, float lo, float up) {
  return (kStream || raw ? valid_px(v) : v < INFINITY) && v >= lo && v <= up;
}

// Counts four values xm into bracket b's packed histogram: by the number
// of midpoints below them when the tree is ordered (values in (lo, hi]
// only), else count(xm <= m[j]) for every midpoint.
__device__ __forceinline__ void count4(unsigned (&w)[4], bool direct, float lo,
                                       float hi, const float* m,
                                       const float (&xm)[4]) {
  if (direct) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int j = 0; j < kBins - 1; ++j)
        w[j >> 2] += xm[e] <= m[j] ? 1u << ((j & 3) << 3) : 0u;
    return;
  }
  bool in[4];
  bool any = false;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    in[e] = xm[e] > lo && xm[e] <= hi;
    any = any || in[e];
  }
  if (!any) return;
  int r[4];
  bucket4(m, xm, r);
#pragma unroll
  for (int e = 0; e < 4; ++e) add_bucket(w, r[e], in[e]);
}

// One bisection pass (with the kept set's moments on the first) over the
// values xm: the kept ones (valid, in [lo_acc, up_acc]) and +inf for the
// rest, as the plain version's xm; absent values (past the part's end)
// are NaN, which no comparison counts.  raw: the shared copy still holds
// the plane as given (the first stats_of).  The first pass of a later
// stats_of has the same tree as the one before it (both start from
// (lo0, vmax]) and a kept set that only lost values: it counts the values
// that left it, and post takes them from the previous counts.
template <bool kStream, int kThreads, bool kMoments, typename Post>
__device__ void tree_pass(Smem& sm, cg::cluster_group& cl, int& parity,
                          const Part& part, bool raw, Post&& post) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  State& st = sm.st;
  const float clo_v = st.lo_acc, cup_v = st.up_acc;
  const float plo = st.prev_lo, pup = st.prev_up;
  // (a direct tree counts +inf too, so it is counted afresh)
  const bool removed_only = kMoments && !raw && !st.direct[0];
  const int nb = st.shared ? 1 : 2;
  const bool direct0 = st.direct[0], direct1 = st.direct[1];
  const float lo0 = st.lo[0], hi0 = st.hi[0], lo1 = st.lo[1], hi1 = st.hi[1];
  const float* m0 = st.mid[0];
  const float* m1 = st.mid[1];
  for (int e = lane; e < kNi; e += 32) sm.warp[warp].i[e] = 0;
  __syncwarp();
  unsigned w[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
  int n = 0;
  double s1 = 0.0, s2 = 0.0;
  const int nq = (part.n + 3) >> 2;
  const int iters = (nq + kThreads - 1) / kThreads;
  for (int it = 0; it < iters; ++it) {
    const int q = it * kThreads + threadIdx.x;
    if (q < nq) {
      const int lim = part.n - 4 * q;
      const float4 v = load4<kStream>(part, q, lim);
      float x4[4] = {v.x, v.y, v.z, v.w};
      float xm[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = x4[e];
        xm[e] = x;
        if (kStream || kMoments) {
          const bool keep = e < lim && kept<kStream>(x, raw, clo_v, cup_v);
          if (kMoments && keep) {
            n += 1;
            const double xd = x;  // its square is exact in f64
            s1 = __dadd_rn(s1, xd);
            s2 = __dadd_rn(s2, __dmul_rn(xd, xd));
          }
          x4[e] = xm[e] = keep ? x : INFINITY;
          if (removed_only) {  // count the values the kept set lost
            const bool was = kStream ? kept<true>(x, true, plo, pup)
                                     : x < INFINITY;
            xm[e] = was && !keep ? x : nanf_();
          }
        }
        if (e >= lim) xm[e] = nanf_();
      }
      if (kMoments && !kStream)  // the shared copy keeps this stats_of's xm
        reinterpret_cast<float4*>(part.s)[q] =
            make_float4(x4[0], x4[1], x4[2], x4[3]);
      count4(w[0], direct0, lo0, hi0, m0, xm);
      if (nb == 2) count4(w[1], direct1, lo1, hi1, m1, xm);
    }
    // 8-bit fields: flush within every 63 loads (252 values a thread)
    if (it % 63 == 62) flush_hist(w, nb, sm.warp[warp]);
  }
  flush_hist(w, nb, sm.warp[warp]);
  if (kMoments) {
    n = __reduce_add_sync(kFull, n);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      sm.warp[warp].i[0] = n;
      sm.warp[warp].d[0] = s1;
      sm.warp[warp].d[1] = s2;
    }
  }
  const FloatOp ops[kNf] = {kMin, kMin, kMin, kMin};  // no floats
  reduce<kThreads>(sm, cl, parity, false, 1 + kBins * nb, 0, kMoments ? 2 : 0,
                   ops, post);
}

template <bool kStream, int kThreads>
__device__ void pin_pass(Smem& sm, cg::cluster_group& cl, int& parity,
                         const Part& part, int64_t hw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  State& st = sm.st;
  const float clo_v = st.lo_acc, cup_v = st.up_acc;
  const float lo0 = st.lo[0], hi0 = st.hi[0], lo1 = st.lo[1], hi1 = st.hi[1];
  const bool two = !st.shared;
  Pin p0{INFINITY, INFINITY, 0}, p1{INFINITY, INFINITY, 0};
  auto take = [](Pin& p, float xm) {
    if (xm < p.m1) {
      p.m2 = p.m1;
      p.m1 = xm;
      p.c = 1;
    } else if (xm == p.m1) {
      p.c += 1;
    } else if (xm < p.m2) {
      p.m2 = xm;
    }
  };
  sweep<kStream, kThreads>(
      part,
      [&](float v) {
        const float xm =
            !kStream || kept<true>(v, true, clo_v, cup_v) ? v : INFINITY;
        if (xm > lo0 && xm <= hi0) take(p0, xm);
        if (two && xm > lo1 && xm <= hi1) take(p1, xm);
      });
  p0 = warp_pin(p0);
  p1 = warp_pin(p1);
  if (lane == 0) {
    sm.warp[warp].f[0] = p0.m1;
    sm.warp[warp].f[1] = p0.m2;
    sm.warp[warp].i[0] = p0.c;
    sm.warp[warp].f[2] = p1.m1;
    sm.warp[warp].f[3] = p1.m2;
    sm.warp[warp].i[1] = p1.c;
  }
  const FloatOp ops[kNf] = {kMin, kMin, kMin, kMin};
  reduce<kThreads>(sm, cl, parity, true, 2, 0, 0, ops, [hw](State& s, const Slot& r) {
    // the k-th value (pallas_stats.py:79-85): the smallest bracket member
    // if count(xm <= it) reaches k, else the next distinct member, else
    // the bracket top.  count(xm <= m1) is the count below the bracket
    // plus m1's multiplicity; every value is <= +inf.
    float rv[2];
    for (int b = 0; b < 2; ++b) {
      const int t = s.shared ? 0 : b;
      const float m1 = r.f[2 * t], m2 = r.f[2 * t + 1];
      const int64_t c1 = isinf(m1) ? hw : s.clo[b] + r.i[t];
      rv[b] = c1 >= s.k[b] ? m1 : (isfinite(m2) ? m2 : s.hi[b]);
    }
    s.med = __fmul_rn(0.5f, __fadd_rn(rv[0], s.k[1] == s.k[0] ? rv[0] : rv[1]));
  });
}

// (n, median, mean, var) of the valid values in [lo_acc, up_acc]
// (ops/stats.py:_stats_of) into sm.st.  Returns true, after the first
// pass, when the kept set is the previous stats_of's (it only loses
// values, so an equal count means an equal set): every later stats_of
// would repeat the previous one bit for bit, so the clip loop is done.
template <bool kStream, int kThreads>
__device__ bool stats_of(Smem& sm, cg::cluster_group& cl, int& parity,
                         const Part& part, int64_t hw, bool raw) {
  tree_pass<kStream, kThreads, true>(
      sm, cl, parity, part, raw, [raw](State& s, Slot& r) {
        s.converged = !raw && r.i[0] == s.prev_n;
        s.prev_n = s.n = r.i[0];
        if (s.converged) return;
        // the counts over the kept set: the previous stats_of's less the
        // values it lost
        for (int j = 0; j < kBins; ++j) {
          if (!raw && !s.direct[0]) r.i[1 + j] = s.hist0[j] - r.i[1 + j];
          s.hist0[j] = r.i[1 + j];
        }
        const int ni = s.n > 1 ? s.n : 1;
        s.k[0] = (ni + 1) / 2;
        s.k[1] = ni / 2 + 1;
        // mean and variance in f64 from the f64 sums, each rounded once
        const double nd = (double)ni;
        const double m = __ddiv_rn(r.d[0], nd);
        const double v = __dsub_rn(__ddiv_rn(r.d[1], nd), __dmul_rn(m, m));
        s.mean = __double2float_rn(m);
        s.var = __double2float_rn(v > 0.0 ? v : 0.0);
        walk(s, r);
        plan_trees(s);
      });
  if (sm.st.converged) return true;
  for (int pass = 1; pass < kPasses; ++pass) {
    tree_pass<kStream, kThreads, false>(sm, cl, parity, part, false,
                                        [](State& s, Slot& r) {
                                          walk(s, r);
                                          plan_trees(s);
                                        });
  }
  pin_pass<kStream, kThreads>(sm, cl, parity, part, hw);
  return false;
}

// 64 registers a thread, so that 1024 / kThreads blocks share an SM
template <bool kStream, int kThreads>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
clip_stats_cluster_kernel(const float* __restrict__ x, int64_t hw, int chunk,
                          float sigma_low, float sigma_up, int maxiters,
                          float* __restrict__ stats, int* __restrict__ counts) {
  extern __shared__ __align__(16) float values[];
  __shared__ Smem sm;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int p = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // a plane may hold up to 2^31 - 1 values: in-plane offsets are 64-bit,
  // a block's part (at most ceil(hw / 16) values) fits an int
  const int64_t start = (int64_t)rank * chunk;
  const float* src = x + p * hw + start;
  Part part;
  part.n = start >= hw ? 0 : (int)(hw - start < chunk ? hw - start : chunk);
  part.g = src;
  part.s = values;
  part.vec4 = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (!kStream) {
    if (part.vec4) {
      const int nq = part.n >> 2;
      for (int q = threadIdx.x; q < nq; q += kThreads)
        reinterpret_cast<float4*>(values)[q] =
            __ldg(reinterpret_cast<const float4*>(src) + q);
      for (int i = 4 * nq + threadIdx.x; i < part.n; i += kThreads)
        values[i] = __ldg(src + i);
    } else {
      for (int i = threadIdx.x; i < part.n; i += kThreads) values[i] = __ldg(src + i);
    }
  }
  int parity = 0;

  // n_valid, min and max of the valid values
  {
    int nv = 0;
    float mn = INFINITY, mx = -INFINITY;
    if (!kStream) __syncthreads();
    sweep<kStream, kThreads>(
        part,
        [&](float v) {
          if (valid_px(v)) {
            nv += 1;
            mn = fminf(mn, v);
            mx = fmaxf(mx, v);
          }
        });
    nv = __reduce_add_sync(kFull, nv);
    mn = warp_min(mn);
    mx = warp_max(mx);
    if (lane == 0) {
      sm.warp[warp].i[0] = nv;
      sm.warp[warp].f[0] = mn;
      sm.warp[warp].f[1] = mx;
      sm.warp[warp].f[2] = 0.0f;
      sm.warp[warp].f[3] = 0.0f;
      for (int e = 1; e < kNi; ++e) sm.warp[warp].i[e] = 0;
    }
    const FloatOp ops[kNf] = {kMin, kMax, kMin, kMin};
    reduce<kThreads>(sm, cl, parity, false, 1, 2, 0, ops,
                     [](State& s, const Slot& r) {
      s.nv = r.i[0];
      const float vmin = r.f[0], vmax = r.f[1];
      const float d = __fsub_rn(vmax, vmin);
      const float span = d < 0.0f ? 0.0f : d;
      // strictly below vmin even for large-magnitude values (f32 rounding)
      s.lo0 = __fsub_rn(__fsub_rn(vmin, __fmul_rn(jmax(span, fabsf(vmin)), 1e-5f)),
                        1e-30f);
      s.vmax = vmax;
      s.lo_acc = -INFINITY;
      s.up_acc = INFINITY;
      s.lower = -INFINITY;
      s.upper = INFINITY;
    });
  }
  float* out = stats + (size_t)p * 5;
  if (sm.st.nv == 0) {  // the same in every block of the cluster
    if (rank == 0 && threadIdx.x == 0) {
      for (int j = 0; j < 5; ++j) out[j] = nanf_();
      counts[2 * p] = 0;
      counts[2 * p + 1] = 0;
    }
    cl.sync();  // no block leaves while another may read its partials
    return;
  }

  for (int it = 0; it <= maxiters; ++it) {
    if (threadIdx.x == 0) {  // every bisection starts from [lo0, vmax]
      State& s = sm.st;
      s.lo[0] = s.lo[1] = s.lo0;
      s.hi[0] = s.hi[1] = s.vmax;
      s.clo[0] = s.clo[1] = 0;
      plan_trees(s);
    }
    __syncthreads();
    if (stats_of<kStream, kThreads>(sm, cl, parity, part, hw, it == 0)) break;
    if (it < maxiters && threadIdx.x == 0) {
      State& s = sm.st;
      s.prev_lo = s.lo_acc;
      s.prev_up = s.up_acc;
      const float sd = __fsqrt_rn(s.var);
      s.lower = __fsub_rn(s.med, __fmul_rn(sigma_low, sd));
      s.upper = __fadd_rn(s.med, __fmul_rn(sigma_up, sd));
      s.lo_acc = jmax(s.lo_acc, s.lower);
      s.up_acc = jmin(s.up_acc, s.upper);
    }
    __syncthreads();
  }
  if (rank == 0 && threadIdx.x == 0) {
    const State& s = sm.st;
    out[0] = s.mean;
    out[1] = s.med;
    out[2] = __fsqrt_rn(s.var);
    out[3] = s.lower;
    out[4] = s.upper;
    counts[2 * p] = s.nv;
    counts[2 * p + 1] = s.n;
  }
  cl.sync();  // no block leaves while another may read its partials
}

template <bool kStream, int kThreads>
int launch(const float* x, float* stats, int* counts, int planes,
           int64_t hw, float sigma_low, float sigma_up, int maxiters,
           int cluster, cudaStream_t stream) {
  auto kernel = clip_stats_cluster_kernel<kStream, kThreads>;
  const int chunk = (int)(((hw + cluster - 1) / cluster + 3) & ~3LL);
  const size_t smem = kStream ? 0 : (size_t)chunk * sizeof(float);
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
  err = cudaLaunchKernelEx(&cfg, kernel, x, hw, chunk, sigma_low, sigma_up,
                           maxiters, stats, counts);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [P, HW] f32 planes -> stats [P, 5] f32 (mean, median, std, lower,
// upper; NaN on a plane with no valid pixel) and counts [P, 2] int32
// (n_valid, final kept count).  One cluster of `cluster` blocks of
// `threads` (512 or 1024) threads a plane; stream_route reads the planes
// from device memory on every pass instead of holding them in shared
// memory.  Planes hold up to 2^31 - 1 values (the counts are int32).
// Returns 0, a CUDA error code, or -1 when the cluster cannot be
// scheduled.
int cy_sigma_clip_stats(const float* x, float* stats, int* counts, int planes,
                        int64_t hw, float sigma_low, float sigma_up,
                        int maxiters, int cluster, int threads,
                        int stream_route, cudaStream_t stream) {
  if (planes == 0) return (int)cudaSuccess;
  if (cluster < 1 || cluster > 16 || planes > 65535 || hw < 1 ||
      hw > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (threads == 1024)
    return stream_route ? launch<true, 1024>(x, stats, counts, planes, hw,
                                              sigma_low, sigma_up, maxiters,
                                              cluster, stream)
                        : launch<false, 1024>(x, stats, counts, planes, hw,
                                               sigma_low, sigma_up, maxiters,
                                               cluster, stream);
  if (threads == 512)
    return stream_route ? launch<true, 512>(x, stats, counts, planes, hw,
                                             sigma_low, sigma_up, maxiters,
                                             cluster, stream)
                        : launch<false, 512>(x, stats, counts, planes, hw,
                                              sigma_low, sigma_up, maxiters,
                                              cluster, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
