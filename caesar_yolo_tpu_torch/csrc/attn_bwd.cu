// Fused C2PSA attention backward: dq, dk, dv of out = softmax(q k^T * s) v.
//
// Replaces caesar_yolo_tpu/models/pallas_attn.py's custom VJP
// (_attention_vjp_fwd / _attention_vjp_bwd, :106-128), which recomputes the
// scores and differentiates _attention_ref.  The rounding points of that
// VJP in the compute type (bf16 or f32) are kept:
//   p   = softmax(s) in f32, p_c = p rounded to the compute type (as the
//         forward);
//   dP  = dO v^T accumulated in f32, then rounded (JAX's transpose of the
//         PV product returns the probabilities' dtype);
//   dS  = p * (dP - rowsum(p * dP)) * scale, in f32 with the f32 p;
//   dq  = dS k, dk = dS^T q, dv = p_c^T dO, accumulated in f32 and rounded
//         once.
// Two launches, no [N, N] tensor in device memory and no atomics, so runs
// repeat bit for bit.  Between them, three f32 vectors a row: the softmax
// max m, its sum l and D = rowsum(p * dP) ([3, B, H, N]).
//
// bf16 (the timed route), by mma.sync m16n8k16 with f32 accumulation, K/V
// or Q/dO tiles brought in by cp.async through a double-buffered ring:
//   1. attn_bwd_dq_mma_kernel, one block of up to 4 warps per (16 query
//      rows a warp, head, batch).  Over the K/V tiles each warp takes its
//      rows' S = Q K^T and dP = dO V^T by MMAs and keeps them on chip in
//      the per-thread layout of the forward (S f32, dP rounded to bf16,
//      which holds it exactly); then m, l, p = e / l in place of S, and D,
//      without leaving the thread (a row's values live in one quad), the
//      division branch-free as in the forward.  Over the K tiles again
//      (a stage then holds K rows alone, more keys a tile) it forms dS
//      from p and dP and takes dq = dS K.
//      dS must not be rounded to bf16 for the tensor cores (one rounding
//      flips >40% of dq's bf16 outputs): it goes in as hi = bf16(dS) and
//      lo = bf16(dS - hi), two MMAs into one f32 accumulator, each product
//      exact, what is dropped ~2^-16 of dS.  Writes dq and m, l, D.
//   2. attn_bwd_dkdv_mma_kernel, one block of up to 4 warps per (16 keys a
//      warp, head, batch), dk and dv of its keys in registers.  Over the
//      Q/dO tiles it recomputes S^T = K Q^T and dP^T = V dO^T by MMAs (the
//      transposed products, so that their C fragments are the A fragments
//      of dv = p_c^T dO and dk = dS^T q), p = expf(s - m) / l and dS with
//      D, and accumulates dv and dk (dS again as hi + lo).  Head widths
//      above 64 take dv 64 columns a pass, recomputing p on the later
//      passes.
// f32 (parity tests only; no timed path runs it): the scalar kernels of
// the first port rearranged the same way (attn_bwd_dq_kernel writes dq and
// m, l, D; attn_bwd_dkdv_kernel recomputes s and dP for 32 keys against
// 32 query rows at a time), because TF32 tensor cores would miss the f32
// parity of 1e-5.
//
// Bound on an H100 at yolo11l@640 training (B=16, H=4, N=400, kd=32,
// hd=64, bf16): q, k, v, dO read and dq, dk, dv written once are 16.4 MB
// (4.9 us at 3.35 TB/s) against 2*B*H*N^2*(3*kd + 2*hd) = 4.6 GFLOP (4.6 us
// at the bf16 tensor-core peak): the bytes bound it, narrowly.  The design
// adds 0.3 MB of row statistics and recomputes S and dP once (2.6 GFLOP
// more), and, like the forward, moves the on-chip rows through shared
// memory several times and computes 2 x 10.2 M expf and divisions.
#include <cstdint>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

using k2::bf16;

// ---------------------------------------------------------------- bf16 ---

constexpr int kMaxWarps = 4;
constexpr int kMaxKT = 64;   // K/V keys per ring stage of launch 1, at most
constexpr int kMaxKTK = 128; // K keys per stage of its dq pass, at most
constexpr int kQT = 32;      // query rows per ring stage of launch 2 (32
                             // ran faster than 64 at N = 400)
constexpr int kChunk = 64;   // dv columns per pass of launch 2

template <int KD>
struct DqLayout {
  static constexpr int kQs = KD + 8;   // Q / K row stride
  int np, hdp, warps, kt;
  __host__ __device__ int ds() const { return hdp + 8; }   // dO / V stride
  // a warp's f32 S (then e, then p) and bf16 dP rows, Q rows, dO rows
  __host__ __device__ size_t s_bytes() const { return (size_t)16 * np * 4; }
  __host__ __device__ size_t warp_bytes() const {
    return s_bytes() + (size_t)16 * np * 2 + 16 * (kQs + ds()) * 2;
  }
  __host__ __device__ size_t stage() const {
    return (size_t)kt * (kQs + ds()) * 2;
  }
  // the dq pass fills the same stage with K rows alone
  __host__ __device__ int ktk() const {
    const int keys = (int)(stage() / 2 / kQs) / 16 * 16;
    return keys < kMaxKTK ? keys : kMaxKTK;
  }
  __host__ __device__ size_t bytes() const {
    return warps * warp_bytes() + 2 * stage();
  }
};

template <int KD>
__global__ void __launch_bounds__(kMaxWarps * 32)
attn_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout, bf16* __restrict__ dq,
                       float* __restrict__ stats, int n, int hd, int kt,
                       float scale, int vec) {
  using L = DqLayout<KD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const L lay{k2::round_up(n, 16), k2::round_up(hd, 16), warps, kt};
  const int np = lay.np, hdp = lay.hdp, ds = lay.ds();
  unsigned char* region = smem + warp * lay.warp_bytes();
  float4* ss = reinterpret_cast<float4*>(region);
  uint2* sdp = reinterpret_cast<uint2*>(region + lay.s_bytes());
  bf16* sq = reinterpret_cast<bf16*>(region + lay.s_bytes() + 16 * np * 2);
  bf16* sdo = sq + 16 * L::kQs;
  unsigned char* ring = smem + warps * lay.warp_bytes();

  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t bhn = (size_t)gridDim.z * gridDim.y * n;
  const int r0 = blockIdx.x * warps * 16 + warp * 16;   // the warp's rows
  const bf16* kb = k + bh * n * KD;
  const bf16* vb = v + bh * n * hd;
  const int nkt = (np + kt - 1) / kt;
  const int ktk = lay.ktk(), nkk = (np + ktk - 1) / ktk;
  const int jobs = nkt + nkk;   // K and V tiles, then K tiles again

  auto stage_k = [&](int job) {
    return reinterpret_cast<bf16*>(ring + (job & 1) * lay.stage());
  };
  auto issue = [&](int job) {
    bf16* st = stage_k(job);
    if (job < nkt) {
      k2::load_tile<KD>(st, L::kQs, kb, KD, n, job * kt, kt, 0, vec);
      k2::load_tile<0>(st + kt * L::kQs, ds, vb, hd, n, job * kt, kt, 0, vec,
                       hdp);
    } else {
      k2::load_tile<KD>(st, L::kQs, kb, KD, n, (job - nkt) * ktk, ktk, 0,
                        vec);
    }
    k2::cp_commit();
  };

  k2::load_tile<KD>(sq, L::kQs, q + bh * n * KD, KD, n, r0, 16, 0, vec, KD,
                    lane, 32);
  k2::load_tile<0>(sdo, ds, dout + bh * n * hd, hd, n, r0, 16, 0, vec, hdp,
                   lane, 32);
  issue(0);

  uint32_t qf[KD / 16][4];
  float mx0 = -INFINITY, mx1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  float d0 = 0.0f, d1 = 0.0f;
  float dqa[KD / 8][4] = {};
  for (int job = 0; job < jobs; ++job) {
    if (job + 1 < jobs) {
      issue(job + 1);
      k2::cp_wait<1>();
    } else {
      k2::cp_wait<0>();
    }
    __syncthreads();
    const bf16* sk = stage_k(job);
    const bool sphase = job < nkt;
    const int k0 = sphase ? job * kt : (job - nkt) * ktk;
    const int kp = min(sphase ? kt : ktk, np - k0) / 16;   // 16-key steps
    if (job == 0) {
#pragma unroll
      for (int ks = 0; ks < KD / 16; ++ks)
        k2::a_frag(qf[ks], sq, L::kQs, 0, ks * 16, lane);
    }
    if (sphase) {
      const bf16* sv = sk + kt * L::kQs;
      // S, 16 keys a step, scaled and masked
#pragma unroll
      for (int p = 0; p < kMaxKT / 16; ++p) {
        if (p >= kp) break;
        float acc[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KD / 16; ++ks) {
          uint32_t b[4];
          k2::b_frag2(b, sk, L::kQs, p * 16, ks * 16, lane);
          k2::mma(acc[0], qf[ks], b[0], b[1]);
          k2::mma(acc[1], qf[ks], b[2], b[3]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = k0 + p * 16 + i * 8 + (lane & 3) * 2;
          float4 s;
          s.x = col < n ? acc[i][0] * scale : -INFINITY;
          s.y = col + 1 < n ? acc[i][1] * scale : -INFINITY;
          s.z = col < n ? acc[i][2] * scale : -INFINITY;
          s.w = col + 1 < n ? acc[i][3] * scale : -INFINITY;
          mx0 = fmaxf(mx0, fmaxf(s.x, s.y));
          mx1 = fmaxf(mx1, fmaxf(s.z, s.w));
          ss[(k0 / 8 + p * 2 + i) * 32 + lane] = s;
        }
      }
      // dP = dO V^T over the tile, the dO fragment of each 16-column step
      // shared by all its keys; rounded to bf16
      float acc[kMaxKT / 8][4] = {};
      for (int ks = 0; ks < hdp / 16; ++ks) {
        uint32_t a[4];
        k2::a_frag(a, sdo, ds, 0, ks * 16, lane);
#pragma unroll
        for (int p = 0; p < kMaxKT / 16; ++p) {
          if (p >= kp) break;
          uint32_t b[4];
          k2::b_frag2(b, sv, ds, p * 16, ks * 16, lane);
          k2::mma(acc[2 * p], a, b[0], b[1]);
          k2::mma(acc[2 * p + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxKT / 8; ++i) {
        if (i >= 2 * kp) break;
        sdp[(k0 / 8 + i) * 32 + lane] =
            make_uint2(k2::pack(acc[i][0], acc[i][1]),
                       k2::pack(acc[i][2], acc[i][3]));
      }
      if (job == nkt - 1) {
        // the warp's row statistics, in place: e = expf(s - m) and l, then
        // p = e / l (kept in place of e) and D = rowsum(p dP)
        mx0 = k2::quad_max(mx0);
        mx1 = k2::quad_max(mx1);
#pragma unroll 4
        for (int b = 0; b < np / 8; ++b) {
          float4 x = ss[b * 32 + lane];
          x.x = expf(x.x - mx0);
          x.y = expf(x.y - mx0);
          x.z = expf(x.z - mx1);
          x.w = expf(x.w - mx1);
          l0 += x.x + x.y;
          l1 += x.z + x.w;
          ss[b * 32 + lane] = x;
        }
        l0 = k2::quad_sum(l0);
        l1 = k2::quad_sum(l1);
        const float r0l = k2::recip(l0), r1l = k2::recip(l1);
#pragma unroll 4
        for (int b = 0; b < np / 8; ++b) {
          float4 x = ss[b * 32 + lane];
          const uint2 dp = sdp[b * 32 + lane];
          const float2 dp0 = k2::unpack(dp.x), dp1 = k2::unpack(dp.y);
          x.x = k2::div_rn(x.x, l0, r0l);
          x.y = k2::div_rn(x.y, l0, r0l);
          x.z = k2::div_rn(x.z, l1, r1l);
          x.w = k2::div_rn(x.w, l1, r1l);
          d0 = fmaf(x.x, dp0.x, d0);
          d0 = fmaf(x.y, dp0.y, d0);
          d1 = fmaf(x.z, dp1.x, d1);
          d1 = fmaf(x.w, dp1.y, d1);
          ss[b * 32 + lane] = x;
        }
        d0 = k2::quad_sum(d0);
        d1 = k2::quad_sum(d1);
      }
    } else {
      // dq += dS K over the tile, dS = p (dP - D) scale fed as hi + lo
#pragma unroll
      for (int p = 0; p < kMaxKTK / 16; ++p) {
        if (p >= kp) break;
        float v8[8];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float4 x = ss[(k0 / 8 + p * 2 + i) * 32 + lane];
          const uint2 dp = sdp[(k0 / 8 + p * 2 + i) * 32 + lane];
          const float2 dp0 = k2::unpack(dp.x), dp1 = k2::unpack(dp.y);
          v8[4 * i + 0] = x.x * (dp0.x - d0) * scale;
          v8[4 * i + 1] = x.y * (dp0.y - d0) * scale;
          v8[4 * i + 2] = x.z * (dp1.x - d1) * scale;
          v8[4 * i + 3] = x.w * (dp1.y - d1) * scale;
        }
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float h0 = k2::round_bf16(v8[2 * r]);
          const float h1 = k2::round_bf16(v8[2 * r + 1]);
          hi[r] = k2::pack(h0, h1);
          lo[r] = k2::pack(v8[2 * r] - h0, v8[2 * r + 1] - h1);
        }
#pragma unroll
        for (int d = 0; d < KD / 16; ++d) {
          uint32_t b[4];
          k2::b_frag2_t(b, sk, L::kQs, p * 16, d * 16, lane);
          k2::mma(dqa[2 * d], hi, b[0], b[1]);
          k2::mma(dqa[2 * d], lo, b[0], b[1]);
          k2::mma(dqa[2 * d + 1], hi, b[2], b[3]);
          k2::mma(dqa[2 * d + 1], lo, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  const int row = r0 + (lane >> 2);
  bf16* dqb = dq + bh * n * KD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + h * 8;
    if (r >= n) continue;
#pragma unroll
    for (int d = 0; d < KD / 8; ++d)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)r * KD + d * 8 +
                                   (lane & 3) * 2) =
          k2::pack(dqa[d][2 * h], dqa[d][2 * h + 1]);
    if ((lane & 3) == 0) {
      float* st = stats + bh * n + r;
      st[0] = h ? mx1 : mx0;
      st[bhn] = h ? l1 : l0;
      st[2 * bhn] = h ? d1 : d0;
    }
  }
}

template <int KD>
struct DkvLayout {
  static constexpr int kQs = KD + 8;
  int hdp, warps;
  __host__ __device__ int ds() const { return hdp + 8; }
  __host__ __device__ size_t kv() const {
    return (size_t)warps * 16 * (kQs + ds()) * 2;
  }
  // Q rows, dO rows, then m, l, D of kQT query rows
  __host__ __device__ size_t stage() const {
    return (size_t)kQT * (kQs + ds()) * 2 + 3 * kQT * 4;
  }
  __host__ __device__ size_t bytes() const { return kv() + 2 * stage(); }
};

template <int KD>
__global__ void __launch_bounds__(kMaxWarps * 32)
attn_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ stats,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int n,
                         int hd, float scale, int vec) {
  using L = DkvLayout<KD>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const L lay{k2::round_up(hd, 16), warps};
  const int np = k2::round_up(n, 16), hdp = lay.hdp, ds = lay.ds();
  const int keys = warps * 16;
  bf16* skb = reinterpret_cast<bf16*>(smem);    // the block's K rows
  bf16* svb = skb + keys * L::kQs;              // and V rows
  unsigned char* ring = smem + lay.kv();

  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t bhn = (size_t)gridDim.z * gridDim.y * n;
  const int j0 = blockIdx.x * keys;
  const bf16* qb = q + bh * n * KD;
  const bf16* dob = dout + bh * n * hd;
  const float* stb = stats + bh * n;
  const int nqt = (np + kQT - 1) / kQT;
  const int nch = (hdp + kChunk - 1) / kChunk;
  const int jobs = nqt * nch;   // per dv column chunk, every Q/dO tile

  auto stage_q = [&](int job) {
    return reinterpret_cast<bf16*>(ring + (job & 1) * lay.stage());
  };
  auto issue = [&](int job) {
    bf16* sq = stage_q(job);
    bf16* sdo = sq + kQT * L::kQs;
    float* sst = reinterpret_cast<float*>(sdo + kQT * ds);
    const int i0 = job % nqt * kQT;
    k2::load_tile<KD>(sq, L::kQs, qb, KD, n, i0, kQT, 0, vec);
    k2::load_tile<0>(sdo, ds, dob, hd, n, i0, kQT, 0, vec, hdp);
    for (int idx = threadIdx.x; idx < 3 * kQT; idx += blockDim.x) {
      const int which = idx / kQT, i = i0 + idx % kQT;
      if (i < n)
        k2::cp_async4(sst + idx, stb + which * bhn + i);
      else
        sst[idx] = which == 1 ? 1.0f : 0.0f;
    }
    k2::cp_commit();
  };

  k2::load_tile<KD>(skb, L::kQs, k + bh * n * KD, KD, n, j0, keys, 0, vec);
  k2::load_tile<0>(svb, ds, v + bh * n * hd, hd, n, j0, keys, 0, vec, hdp);
  issue(0);

  uint32_t kf[KD / 16][4];
  float dka[KD / 8][4] = {};
  float dva[kChunk / 8][4];
  for (int job = 0; job < jobs; ++job) {
    if (job + 1 < jobs) {
      issue(job + 1);
      k2::cp_wait<1>();
    } else {
      k2::cp_wait<0>();
    }
    __syncthreads();
    const bf16* sq = stage_q(job);
    const bf16* sdo = sq + kQT * L::kQs;
    const float* sst = reinterpret_cast<const float*>(sdo + kQT * ds);
    const int c = job / nqt, t = job % nqt, i0 = t * kQT;
    const int qp = min(kQT, np - i0) / 16;
    const int c0 = c * kChunk, ndt = min(kChunk, hdp - c0) / 8;
    if (job == 0) {
#pragma unroll
      for (int ks = 0; ks < KD / 16; ++ks)
        k2::a_frag(kf[ks], skb, L::kQs, warp * 16, ks * 16, lane);
    }
    if (t == 0) {
#pragma unroll
      for (int d = 0; d < kChunk / 8; ++d)
        dva[d][0] = dva[d][1] = dva[d][2] = dva[d][3] = 0.0f;
    }
    // S^T = K Q^T (rows: the warp's keys; columns: the tile's queries)
    float sa[kQT / 8][4] = {};
#pragma unroll
    for (int p = 0; p < kQT / 16; ++p) {
      if (p >= qp) break;
#pragma unroll
      for (int ks = 0; ks < KD / 16; ++ks) {
        uint32_t b[4];
        k2::b_frag2(b, sq, L::kQs, p * 16, ks * 16, lane);
        k2::mma(sa[2 * p], kf[ks], b[0], b[1]);
        k2::mma(sa[2 * p + 1], kf[ks], b[2], b[3]);
      }
    }
    // dP^T = V dO^T, on the first column pass only
    float pa[kQT / 8][4] = {};
    if (c == 0) {
      for (int ks = 0; ks < hdp / 16; ++ks) {
        uint32_t a[4];
        k2::a_frag(a, svb, ds, warp * 16, ks * 16, lane);
#pragma unroll
        for (int p = 0; p < kQT / 16; ++p) {
          if (p >= qp) break;
          uint32_t b[4];
          k2::b_frag2(b, sdo, ds, p * 16, ks * 16, lane);
          k2::mma(pa[2 * p], a, b[0], b[1]);
          k2::mma(pa[2 * p + 1], a, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kQT / 16; ++p) {
      if (p >= qp) break;
      // A fragments of this 16-query step: p_c^T, and dS^T as hi + lo.
      // Register r = 2 i + h holds rows (keys) g + 8 h of block 2 p + i.
      uint32_t pc[4], hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = p * 16 + i * 8 + (lane & 3) * 2;   // in the tile
        const float l[2] = {sst[kQT + col], sst[kQT + col + 1]};
        const float rl[2] = {k2::recip(l[0]), k2::recip(l[1])};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float pr[2], dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = col + e;
            const float s = sa[2 * p + i][2 * h + e] * scale;
            pr[e] = i0 + qi < n
                        ? k2::div_rn(expf(s - sst[qi]), l[e], rl[e]) : 0.0f;
            dsv[e] = pr[e] * (k2::round_bf16(pa[2 * p + i][2 * h + e]) -
                              sst[2 * kQT + qi]) * scale;
          }
          pc[2 * i + h] = k2::pack(pr[0], pr[1]);
          const float h0 = k2::round_bf16(dsv[0]);
          const float h1 = k2::round_bf16(dsv[1]);
          hi[2 * i + h] = k2::pack(h0, h1);
          lo[2 * i + h] = k2::pack(dsv[0] - h0, dsv[1] - h1);
        }
      }
      // dv (this column pass) += p_c^T dO
#pragma unroll
      for (int d = 0; d < kChunk / 16; ++d) {
        if (2 * d >= ndt) break;
        uint32_t b[4];
        k2::b_frag2_t(b, sdo, ds, p * 16, c0 + d * 16, lane);
        k2::mma(dva[2 * d], pc, b[0], b[1]);
        k2::mma(dva[2 * d + 1], pc, b[2], b[3]);
      }
      if (c == 0) {
        // dk += dS^T q
#pragma unroll
        for (int d = 0; d < KD / 16; ++d) {
          uint32_t b[4];
          k2::b_frag2_t(b, sq, L::kQs, p * 16, d * 16, lane);
          k2::mma(dka[2 * d], hi, b[0], b[1]);
          k2::mma(dka[2 * d], lo, b[0], b[1]);
          k2::mma(dka[2 * d + 1], hi, b[2], b[3]);
          k2::mma(dka[2 * d + 1], lo, b[2], b[3]);
        }
      }
    }
    if (t == nqt - 1) {
      const int key = j0 + warp * 16 + (lane >> 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = key + h * 8;
        if (r >= n) continue;
        bf16* dvr = dv + (bh * n + r) * hd;
#pragma unroll
        for (int d = 0; d < kChunk / 8; ++d) {
          const int col = c0 + d * 8 + (lane & 3) * 2;
          if (d >= ndt || col >= hd) continue;
          if (col + 1 < hd && (hd & 1) == 0) {
            *reinterpret_cast<uint32_t*>(dvr + col) =
                k2::pack(dva[d][2 * h], dva[d][2 * h + 1]);
          } else {
            dvr[col] = __float2bfloat16_rn(dva[d][2 * h]);
            if (col + 1 < hd) dvr[col + 1] = __float2bfloat16_rn(dva[d][2 * h + 1]);
          }
        }
        if (c == 0) {
          bf16* dkr = dk + (bh * n + r) * KD;
#pragma unroll
          for (int d = 0; d < KD / 8; ++d)
            *reinterpret_cast<uint32_t*>(dkr + d * 8 + (lane & 3) * 2) =
                k2::pack(dka[d][2 * h], dka[d][2 * h + 1]);
        }
      }
    }
    __syncthreads();
  }
}

// Block shapes: the most warps resident on an SM (the dq launch keeps a
// warp's S and dP rows, 96 N bytes, in shared memory), ties to more warps
// a block and then longer stages.
template <int KD>
DqLayout<KD> dq_layout(int n, int hd) {
  DqLayout<KD> best{k2::round_up(n, 16), k2::round_up(hd, 16), 0, 0};
  int best_res = 0;
  for (int w = kMaxWarps; w >= 1; w >>= 1) {
    for (int kt = kMaxKT; kt >= 16; kt >>= 1) {
      const DqLayout<KD> lay{best.np, best.hdp, w, kt};
      const int res = k2::warps_per_sm(w, lay.bytes());
      if (res > best_res) {
        best = lay;
        best_res = res;
      }
    }
  }
  return best;
}

template <int KD>
DkvLayout<KD> dkv_layout(int hd) {
  DkvLayout<KD> best{k2::round_up(hd, 16), 0};
  int best_res = 0;
  for (int w = kMaxWarps; w >= 1; w >>= 1) {
    const DkvLayout<KD> lay{best.hdp, w};
    const int res = k2::warps_per_sm(w, lay.bytes());
    if (res > best_res) {
      best = lay;
      best_res = res;
    }
  }
  return best;
}

template <int KD>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, float* stats, int b, int h,
               int n, int hd, float scale, cudaStream_t stream) {
  static size_t reserved_dq = 0, reserved_dkdv = 0;
  const DqLayout<KD> l1 = dq_layout<KD>(n, hd);
  const DkvLayout<KD> l2 = dkv_layout<KD>(hd);
  if (l1.warps == 0 || l2.warps == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = k2::reserve_smem(
      reinterpret_cast<const void*>(attn_bwd_dq_mma_kernel<KD>), l1.bytes(),
      &reserved_dq);
  if (err == cudaSuccess)
    err = k2::reserve_smem(
        reinterpret_cast<const void*>(attn_bwd_dkdv_mma_kernel<KD>),
        l2.bytes(), &reserved_dkdv);
  if (err != cudaSuccess) return (int)err;
  const int vec = ((reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) |
                    reinterpret_cast<uintptr_t>(dout)) % 16 == 0) &&
                  hd % 8 == 0;
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k);
  const bf16 *vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  dim3 grid1((n + l1.warps * 16 - 1) / (l1.warps * 16), h, b);
  attn_bwd_dq_mma_kernel<KD><<<grid1, l1.warps * 32, l1.bytes(), stream>>>(
      qp, kp, vp, dop, static_cast<bf16*>(dq), stats, n, hd, l1.kt, scale,
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid2((n + l2.warps * 16 - 1) / (l2.warps * 16), h, b);
  attn_bwd_dkdv_mma_kernel<KD><<<grid2, l2.warps * 32, l2.bytes(), stream>>>(
      qp, kp, vp, dop, stats, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      n, hd, scale, vec);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- f32 ---

constexpr int kThreads = 256;
constexpr int kRowsPerPass = 8;
constexpr size_t kSmemLimit = 200 * 1024;
constexpr int kChunkD = 32;   // head-width padding of the f32 kernels
constexpr int kCols = 32;     // key rows per block of the f32 dk/dv launch
constexpr int kChunkI = 32;   // query rows per shared-memory chunk there

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ __forceinline__ int padded(int x) {
  return (x + kChunkD - 1) / kChunkD * kChunkD;
}

int rows_per_block(int n, int kd, int hd) {
  int rows = 64;
  while (rows > 8 &&
         (size_t)rows * (2 * n + kd + padded(hd)) * sizeof(float) > kSmemLimit)
    rows >>= 1;
  return rows;
}

// one block per (tile of query rows, head, batch): the tile's score and dP
// rows in shared memory, one warp per row for the statistics, dq = dS k
template <int KD>
__global__ void attn_bwd_dq_kernel(const float* __restrict__ q,
                                   const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   const float* __restrict__ dout,
                                   float* __restrict__ dq,
                                   float* __restrict__ stats, int n, int hd,
                                   int rows, float scale) {
  extern __shared__ __align__(16) float smem_f[];
  const int hdp = padded(hd);
  float* p = smem_f;                        // [rows, n] scores, then p
  float* dp = p + (size_t)rows * n;         // [rows, n] dP, then dS
  float* qs = dp + (size_t)rows * n;        // [rows, KD]
  float* dos = qs + (size_t)rows * KD;      // [rows, hdp], zero padded
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t bhn = (size_t)gridDim.z * gridDim.y * n;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, n - r0);
  const float* qb = q + (bh * n + r0) * KD;
  const float* kb = k + bh * n * KD;
  const float* vb = v + bh * n * hd;
  const float* dob = dout + (bh * n + r0) * hd;
  float* dqb = dq + (bh * n + r0) * KD;
  float* stb = stats + bh * n + r0;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < nr * KD; idx += blockDim.x) qs[idx] = qb[idx];
  for (int idx = tid; idx < rows * hdp; idx += blockDim.x) {
    const int r = idx / hdp, d = idx % hdp;
    dos[idx] = (r < nr && d < hd) ? dob[(size_t)r * hd + d] : 0.0f;
  }
  __syncthreads();

  // scores and dP: one key column per thread, its key row in registers,
  // its value row in chunks of kChunkD
  for (int j = tid; j < n; j += blockDim.x) {
    float kr[KD];
#pragma unroll
    for (int d = 0; d < KD; ++d) kr[d] = kb[(size_t)j * KD + d];
    for (int r = 0; r < nr; ++r) {
      const float* qr = qs + r * KD;
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < KD; ++d) acc = fmaf(qr[d], kr[d], acc);
      p[(size_t)r * n + j] = acc * scale;
      dp[(size_t)r * n + j] = 0.0f;
    }
    for (int d0 = 0; d0 < hdp; d0 += kChunkD) {
      float vr[kChunkD];
#pragma unroll
      for (int dd = 0; dd < kChunkD; ++dd)
        vr[dd] = d0 + dd < hd ? vb[(size_t)j * hd + d0 + dd] : 0.0f;
      for (int r = 0; r < nr; ++r) {
        const float* dr = dos + (size_t)r * hdp + d0;
        float acc = 0.0f;
#pragma unroll
        for (int dd = 0; dd < kChunkD; ++dd) acc = fmaf(dr[dd], vr[dd], acc);
        dp[(size_t)r * n + j] += acc;
      }
    }
  }
  __syncthreads();

  // per row (one warp): softmax as the forward, rowsum(p dP), dS; the
  // row's m, l and D for the dk/dv launch
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  for (int r = warp; r < nr; r += nwarps) {
    float* prow = p + (size_t)r * n;
    float* dprow = dp + (size_t)r * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, prow[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float dot = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float pj = prow[j] / sum;
      prow[j] = pj;
      dot = fmaf(pj, dprow[j], dot);
    }
    dot = warp_sum(dot);
    for (int j = lane; j < n; j += 32)
      dprow[j] = prow[j] * (dprow[j] - dot) * scale;
    if (lane == 0) {
      stb[r] = m;
      stb[bhn + r] = sum;
      stb[2 * bhn + r] = dot;
    }
  }
  __syncthreads();

  // dq = dS k: thread owns column d for kRowsPerPass rows per pass
  const int groups = blockDim.x / KD;
  const int d = tid % KD;
  const int g = tid / KD;
  if (g < groups) {
    for (int rb = g * kRowsPerPass; rb < nr; rb += groups * kRowsPerPass) {
      float acc[kRowsPerPass];
#pragma unroll
      for (int u = 0; u < kRowsPerPass; ++u) acc[u] = 0.0f;
      for (int j = 0; j < n; ++j) {
        const float kk = kb[(size_t)j * KD + d];
#pragma unroll
        for (int u = 0; u < kRowsPerPass; ++u) {
          const int r = min(rb + u, nr - 1);
          acc[u] = fmaf(dp[(size_t)r * n + j], kk, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsPerPass; ++u)
        if (rb + u < nr) dqb[(size_t)(rb + u) * KD + d] = acc[u];
    }
  }
}

// one block per (tile of kCols key rows, head, batch): for each chunk of
// kChunkI query rows, p and dS of the chunk x tile recomputed (s and dP by
// the same FMA order as attn_bwd_dq_kernel, with its m, l, D), then
// dk += dS^T q and dv += p^T dO
template <int KD>
__global__ void attn_bwd_dkdv_kernel(const float* __restrict__ q,
                                     const float* __restrict__ k,
                                     const float* __restrict__ v,
                                     const float* __restrict__ dout,
                                     const float* __restrict__ stats,
                                     float* __restrict__ dk,
                                     float* __restrict__ dv, int n, int hd,
                                     float scale) {
  extern __shared__ __align__(16) float smem_f[];
  const int hdp = padded(hd);
  float* sk = smem_f;                   // [kCols, KD]
  float* sv = sk + kCols * KD;          // [kCols, hdp]
  float* sq = sv + kCols * hdp;         // [kChunkI, KD]
  float* sdo = sq + kChunkI * KD;       // [kChunkI, hdp]
  float* sp = sdo + kChunkI * hdp;      // [kChunkI, kCols] p
  float* sds = sp + kChunkI * kCols;    // [kChunkI, kCols] dS
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t bhn = (size_t)gridDim.z * gridDim.y * n;
  const int j0 = blockIdx.x * kCols;
  const int nc = min(kCols, n - j0);
  const int tid = threadIdx.x;
  const float* qb = q + bh * n * KD;
  const float* dob = dout + bh * n * hd;
  const float* m = stats + bh * n;

  for (int idx = tid; idx < kCols * KD; idx += kThreads) {
    const int jj = idx / KD;
    sk[idx] = jj < nc ? k[(bh * n + j0 + jj) * KD + idx % KD] : 0.0f;
  }
  for (int idx = tid; idx < kCols * hdp; idx += kThreads) {
    const int jj = idx / hdp, e = idx % hdp;
    sv[idx] = jj < nc && e < hd ? v[(bh * n + j0 + jj) * hd + e] : 0.0f;
  }

  constexpr int kPerDk = kCols * KD / kThreads;
  constexpr int kMaxDv = kCols * 256 / kThreads;   // hd <= 256
  const int per_dv = kCols * hdp / kThreads;
  float acck[kPerDk], accv[kMaxDv];
#pragma unroll
  for (int u = 0; u < kPerDk; ++u) acck[u] = 0.0f;
#pragma unroll
  for (int u = 0; u < kMaxDv; ++u) accv[u] = 0.0f;
  for (int i0 = 0; i0 < n; i0 += kChunkI) {
    const int ni = min(kChunkI, n - i0);
    for (int idx = tid; idx < kChunkI * KD; idx += kThreads) {
      const int ii = idx / KD;
      sq[idx] = ii < ni ? qb[(size_t)(i0 + ii) * KD + idx % KD] : 0.0f;
    }
    for (int idx = tid; idx < kChunkI * hdp; idx += kThreads) {
      const int ii = idx / hdp, e = idx % hdp;
      sdo[idx] = ii < ni && e < hd ? dob[(size_t)(i0 + ii) * hd + e] : 0.0f;
    }
    __syncthreads();
    for (int idx = tid; idx < kChunkI * kCols; idx += kThreads) {
      const int ii = idx / kCols, jj = idx % kCols;
      float pv = 0.0f, dsv = 0.0f;
      if (ii < ni) {
        const int i = i0 + ii;
        float s = 0.0f;
#pragma unroll
        for (int d = 0; d < KD; ++d) s = fmaf(sq[ii * KD + d], sk[jj * KD + d], s);
        float dpv = 0.0f;
        for (int d0 = 0; d0 < hdp; d0 += kChunkD) {
          float acc = 0.0f;
#pragma unroll
          for (int dd = 0; dd < kChunkD; ++dd)
            acc = fmaf(sdo[ii * hdp + d0 + dd], sv[jj * hdp + d0 + dd], acc);
          dpv += acc;
        }
        pv = expf(s * scale - m[i]) / m[bhn + i];
        dsv = pv * (dpv - m[2 * bhn + i]) * scale;
      }
      sp[idx] = pv;
      sds[idx] = dsv;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPerDk; ++u) {
      const int o = tid + u * kThreads;
      const int jj = o / KD, d = o % KD;
      for (int ii = 0; ii < kChunkI; ++ii)
        acck[u] = fmaf(sds[ii * kCols + jj], sq[ii * KD + d], acck[u]);
    }
#pragma unroll
    for (int u = 0; u < kMaxDv; ++u) {
      if (u >= per_dv) break;
      const int o = tid + u * kThreads;
      const int jj = o / hdp, e = o % hdp;
      for (int ii = 0; ii < kChunkI; ++ii)
        accv[u] = fmaf(sp[ii * kCols + jj], sdo[ii * hdp + e], accv[u]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < kPerDk; ++u) {
    const int o = tid + u * kThreads;
    const int jj = o / KD;
    if (jj < nc) dk[(bh * n + j0 + jj) * KD + o % KD] = acck[u];
  }
#pragma unroll
  for (int u = 0; u < kMaxDv; ++u) {
    if (u >= per_dv) break;
    const int o = tid + u * kThreads;
    const int jj = o / hdp, e = o % hdp;
    if (jj < nc && e < hd) dv[(bh * n + j0 + jj) * hd + e] = accv[u];
  }
}

template <int KD>
int launch_f32(const void* q, const void* k, const void* v, const void* dout,
               void* dq, void* dk, void* dv, float* stats, int b, int h,
               int n, int hd, float scale, cudaStream_t stream) {
  const int rows = rows_per_block(n, KD, hd);
  const size_t smem = (size_t)rows * (2 * n + KD + padded(hd)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 =
      ((size_t)(kCols + kChunkI) * (KD + padded(hd)) + 2 * kChunkI * kCols) *
      sizeof(float);
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<KD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k);
  const float *vp = static_cast<const float*>(v);
  const float* dop = static_cast<const float*>(dout);
  dim3 grid1((n + rows - 1) / rows, h, b);
  attn_bwd_dq_kernel<KD><<<grid1, kThreads, smem, stream>>>(
      qp, kp, vp, dop, static_cast<float*>(dq), stats, n, hd, rows, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid2((n + kCols - 1) / kCols, h, b);
  attn_bwd_dkdv_kernel<KD><<<grid2, kThreads, smem2, stream>>>(
      qp, kp, vp, dop, stats, static_cast<float*>(dk), static_cast<float*>(dv),
      n, hd, scale);
  return (int)cudaGetLastError();
}

template <int KD>
int dispatch_dtype(const void* q, const void* k, const void* v,
                   const void* dout, void* dq, void* dk, void* dv,
                   float* stats, int b, int h, int n, int hd, int dtype,
                   float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_f32<KD>(q, k, v, dout, dq, dk, dv, stats, b, h, n, hd,
                          scale, stream);
  if (dtype == 1)
    return launch_mma<KD>(q, k, v, dout, dq, dk, dv, stats, b, h, n, hd,
                          scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, dq, dk [B, H, N, kd]; v, dout, dv [B, H, N, hd]; stats f32
// [3, B, H, N] (m, l, D, written by the first launch, read by the second);
// all contiguous; dtype 0 = f32, 1 = bf16.  kd in {16, 32, 64},
// 1 <= hd <= 256, 8 <= N <= 2048.
int cy_attention_bwd(const void* q, const void* k, const void* v,
                     const void* dout, void* dq, void* dk, void* dv,
                     float* stats, int b, int h, int n, int kd, int hd,
                     int dtype, float scale, cudaStream_t stream) {
  if (hd < 1 || hd > 256 || n < 1 || n > 2048)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return (int)cudaSuccess;
  switch (kd) {
    case 16: return dispatch_dtype<16>(q, k, v, dout, dq, dk, dv, stats, b, h, n, hd, dtype, scale, stream);
    case 32: return dispatch_dtype<32>(q, k, v, dout, dq, dk, dv, stats, b, h, n, hd, dtype, scale, stream);
    case 64: return dispatch_dtype<64>(q, k, v, dout, dq, dk, dv, stats, b, h, n, hd, dtype, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
