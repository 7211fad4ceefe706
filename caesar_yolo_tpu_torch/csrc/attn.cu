// Fused C2PSA attention forward: out = softmax(q k^T * scale) v.
//
// Replaces caesar_yolo_tpu/models/pallas_attn.py:attention_pallas
// (_attn_kernel, :56-69), which keeps each (batch, head)'s [N, N] f32
// score matrix in VMEM.
//
// Numerics (the reference's, pallas_attn.py:63-68): scores are f32 dot
// products multiplied by `scale` after the dot; a max-subtracted f32
// softmax with one expf per score; the probability rounded to the compute
// type AFTER normalising (an online softmax with deferred normalisation
// rounds p differently and fails the bf16 rule); PV accumulated in f32 and
// rounded once.
//
// bf16 (the timed route), attn_fwd_mma_kernel: one block of up to 4
// compute warps per (tile of 16 query rows a warp, head, batch), and one
// producer warp that streams K and V tiles by cp.async through a
// double-buffered shared-memory ring, each stage handed over by mbarriers
// (full when its copies land, empty when every compute warp is done
// with it): the compute warps never wait for each other, only for data.
// Each compute warp loads its Q fragments once (ldmatrix) and takes
// S = Q K^T by mma.sync m16n8k16 with f32 accumulation.  Its whole f32
// score rows stay on chip, in a per-thread layout (each thread keeps the
// C-fragment values it produced: 16-byte accesses, no bank conflicts, no
// barrier), where the softmax runs in place: row max, expf, row sum, then
// p = bf16(e / sum) by a branch-free division that rounds as the IEEE one
// does (the compiler's division branches on every call and serialised the
// loop).  Then the V tiles stream through the same ring, 64 output
// columns a pass: the C fragments of two 8-key score blocks are exactly
// the A fragment of the PV MMA's 16-key k-step, so p goes from the
// thread's own slots to the tensor cores.  Each 16-key step reads the
// next step's fragments ahead.  A stage holds a V tile of 16-128 keys in
// unpadded, swizzled 128-byte rows, or 1.6x as many K rows (KD = 32,
// padded rows): at N = 400, 48-key V tiles and 64-key K tiles.
// Ragged N is padded to 16 keys (scores of padded keys -inf, their V rows
// zero), ragged head widths to 16 columns (zero).  The score rows cost
// 64 N bytes a warp (25.6 KB at N = 400), which caps an SM at 8 resident
// compute warps there; the launcher picks the block shape that keeps 8
// resident with the longest tiles.
//
// f32 (parity tests only; no timed path runs it), attn_fwd_kernel: the
// scalar kernel of the first port, kept because TF32 tensor cores would
// miss the f32 parity of 1e-5.
//
// Bound on an H100 at yolo11l@640, B=32: 2*B*H*N^2*(kd+hd) = 3.9 GFLOP
// and 19.7 MB of q/k/v/out in bf16: ~4 us at the bf16 tensor-core peak
// (989 TFLOP/s) against ~5.9 us at 3.35 TB/s, so the bound is the bytes.
// Besides the MMAs the kernel does 20.5 M expf and divisions and moves
// each score through shared memory five times (store, softmax read and
// write, p write, PV read), at 8 compute warps an SM: these and the tail
// of the last wave (896 blocks on 264 slots), not the MMAs, set its time
// (PERF.md).
#include <cstdint>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

using k2::bf16;

// ---------------------------------------------------------------- bf16 ---

constexpr int kMaxWarps = 4;
constexpr int kMaxKT = 128;       // keys per ring stage, at most
constexpr int kStages = 2;        // ring stages: tiles in flight + 1
constexpr int kChunk = 64;        // output columns per PV pass

// A ring stage holds kt V rows (a 64-column chunk, swizzled: load_tile)
// or, in the same bytes, ktk() K rows (KD columns, padded to KD + 8).
template <int KD>
struct FwdLayout {
  static constexpr int kQs = KD + 8;                // Q / K row stride
  int np, warps, kt;
  __host__ __device__ int stage() const {           // elements a stage
    return kt * kChunk;
  }
  __host__ __device__ int ktk() const {
    const int keys = stage() / kQs / 16 * 16;
    return keys < kMaxKT ? keys : kMaxKT;
  }
  // a warp's f32 score rows; its Q rows sit there until the first scores
  __host__ __device__ size_t warp_bytes() const {
    const size_t s = (size_t)16 * np * sizeof(float);
    const size_t qb = (size_t)16 * kQs * sizeof(bf16);
    return s > qb ? s : qb;
  }
  __host__ __device__ size_t bytes() const {
    // + the ring's full and empty mbarriers
    return warps * warp_bytes() + kStages * (size_t)stage() * sizeof(bf16) +
           2 * kStages * sizeof(uint64_t);
  }
};

template <int KD>
__global__ void __launch_bounds__((kMaxWarps + 1) * 32)
attn_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out, int n,
                    int hd, int kt, float scale, int vec) {
  using L = FwdLayout<KD>;
  extern __shared__ __align__(16) unsigned char smem[];
  // warps 0 .. warps-1 compute, warp `warps` only copies K/V tiles
  const int warps = (blockDim.x >> 5) - 1, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const L lay{k2::round_up(n, 16), warps, kt};
  const int np = lay.np, hdp = k2::round_up(hd, 16);
  const int rows = warps * 16;
  // this warp's score rows: float4 (t, lane) holds the lane's C values of
  // the 8-key block t: (g, c), (g, c+1), (g+8, c), (g+8, c+1)
  unsigned char* region = smem + warp * lay.warp_bytes();
  float4* ss = reinterpret_cast<float4*>(region);
  uint2* sp = reinterpret_cast<uint2*>(region);   // p over e, see below
  bf16* ring = reinterpret_cast<bf16*>(smem + warps * lay.warp_bytes());
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * lay.stage());
  uint64_t* empty = full + kStages;

  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const bf16* kb = k + bh * n * KD;
  const bf16* vb = v + bh * n * hd;
  const int ktk = lay.ktk();
  const int nkk = (np + ktk - 1) / ktk;         // K tiles
  const int nkv = (np + kt - 1) / kt;           // V tiles a column chunk
  const int nch = (hdp + kChunk - 1) / kChunk;  // output column chunks
  const int jobs = nkk + nch * nkv;             // K tiles, then V tiles

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      k2::mbar_init(full + i, 64);      // the producer's 32 lanes, twice
      k2::mbar_init(empty + i, warps);  // one lane a consumer warp
    }
  }
  __syncthreads();
  if (warp == warps) {
    // the producer: fills stage job % kStages once every consumer has
    // released it; the stage's phase completes when the copies have
    // landed and the zero fills of padded rows are released.  Job j < nkk
    // is K tile j, else V tile (j - nkk) % nkv of chunk (j - nkk) / nkv.
    for (int job = 0; job < jobs; ++job) {
      const int si = job % kStages;
      if (job >= kStages) k2::mbar_wait(empty + si, (job / kStages - 1) & 1);
      bf16* st = ring + si * lay.stage();
      if (job < nkk) {
        k2::load_tile<KD>(st, L::kQs, kb, KD, n, job * ktk, ktk, 0, vec, KD,
                          lane, 32);
      } else {
        const int t = (job - nkk) % nkv, c0 = (job - nkk) / nkv * kChunk;
        k2::load_tile<kChunk, true>(st, 0, vb, hd, n, t * kt, kt, c0, vec,
                                    kChunk, lane, 32);
      }
      k2::cp_async_arrive(full + si);
      k2::mbar_arrive(full + si);
    }
    k2::cp_wait<0>();
    return;
  }

  // each consumer warp copies its own 16 query rows into its score region
  k2::load_tile<KD>(reinterpret_cast<bf16*>(region), L::kQs, q + bh * n * KD,
                    KD, n, r0 + warp * 16, 16, 0, vec, KD, lane, 32);
  k2::cp_commit();
  k2::cp_wait<0>();
  __syncwarp();

  uint32_t qf[KD / 16][4];
  float mx0 = -INFINITY, mx1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  float o[kChunk / 8][4];
  // this lane's ldmatrix.trans row in a 16-key step of a V tile, and its
  // swizzled column offsets for the four 16-column blocks of the chunk
  const int vrow = ((lane & 7) + ((lane >> 3) & 1) * 8) * kChunk;
  int voff[kChunk / 16];
#pragma unroll
  for (int d = 0; d < kChunk / 16; ++d)
    voff[d] = vrow + (((2 * d + (lane >> 4)) ^ (lane & 7)) << 3);
  for (int job = 0; job < jobs; ++job) {
    k2::mbar_wait(full + job % kStages, (job / kStages) & 1);
    const bf16* st = ring + job % kStages * lay.stage();
    const bool kphase = job < nkk;
    const int t = kphase ? job : (job - nkk) % nkv;
    const int k0 = t * (kphase ? ktk : kt);
    const int kp = min(kphase ? ktk : kt, np - k0) / 16;   // 16-key steps
    if (job == 0) {
#pragma unroll
      for (int ks = 0; ks < KD / 16; ++ks)
        k2::a_frag(qf[ks], reinterpret_cast<const bf16*>(region), L::kQs, 0,
                   ks * 16, lane);
      __syncwarp();
    }
    if (kphase) {
      // S, 16 keys a step (the next step's K fragments read ahead):
      // scaled, padded keys masked, kept on chip
      uint32_t bn[KD / 16][4];
#pragma unroll
      for (int ks = 0; ks < KD / 16; ++ks)
        k2::b_frag2(bn[ks], st, L::kQs, 0, ks * 16, lane);
#pragma unroll
      for (int p = 0; p < kMaxKT / 16; ++p) {
        if (p >= kp) break;
        uint32_t b[KD / 16][4];
#pragma unroll
        for (int ks = 0; ks < KD / 16; ++ks)
#pragma unroll
          for (int r = 0; r < 4; ++r) b[ks][r] = bn[ks][r];
        if (p + 1 < kp) {
#pragma unroll
          for (int ks = 0; ks < KD / 16; ++ks)
            k2::b_frag2(bn[ks], st, L::kQs, (p + 1) * 16, ks * 16, lane);
        }
        float acc[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < KD / 16; ++ks) {
          k2::mma(acc[0], qf[ks], b[ks][0], b[ks][1]);
          k2::mma(acc[1], qf[ks], b[ks][2], b[ks][3]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float4 s = make_float4(acc[i][0] * scale, acc[i][1] * scale,
                                 acc[i][2] * scale, acc[i][3] * scale);
          if (k0 + ktk > n) {   // the last tile: padded keys score -inf
            const int col = k0 + p * 16 + i * 8 + (lane & 3) * 2;
            if (col >= n) s.x = s.z = -INFINITY;
            if (col + 1 >= n) s.y = s.w = -INFINITY;
          }
          mx0 = fmaxf(mx0, fmaxf(s.x, s.y));
          mx1 = fmaxf(mx1, fmaxf(s.z, s.w));
          ss[(k0 / 8 + p * 2 + i) * 32 + lane] = s;
        }
      }
      if (job == nkk - 1) {
        // softmax of the warp's rows in place (the first V tile is in
        // flight): the row max over the quad, e = expf(s - max), the sum
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
        // p = bf16(e / sum), kept in the first half of e's slot: the
        // lane's two bf16 pairs there are its A registers of the PV MMA
        const float r0l = k2::recip(l0), r1l = k2::recip(l1);
#pragma unroll 4
        for (int b = 0; b < np / 8; ++b) {
          const float4 x = ss[b * 32 + lane];
          sp[b * 64 + 2 * lane] = make_uint2(
              k2::pack(k2::div_rn(x.x, l0, r0l), k2::div_rn(x.y, l0, r0l)),
              k2::pack(k2::div_rn(x.z, l1, r1l), k2::div_rn(x.w, l1, r1l)));
        }
      }
    } else {
      const int c0 = (job - nkk) / nkv * kChunk;
      const int ndt = min(kChunk, hdp - c0) / 8;   // 8-column blocks, even
      if (t == 0) {
#pragma unroll
        for (int d = 0; d < kChunk / 8; ++d)
          o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.0f;
      }
      // two 8-key C blocks of p make one 16-key A fragment; the next
      // step's p and V fragments are read ahead
      uint2 p0 = sp[(k0 / 8) * 64 + 2 * lane];
      uint2 p1 = sp[(k0 / 8 + 1) * 64 + 2 * lane];
      uint32_t bn[kChunk / 16][4];
#pragma unroll
      for (int d = 0; d < kChunk / 16; ++d)
        if (2 * d < ndt) k2::ldsm_x4_t(bn[d], st + voff[d]);
#pragma unroll
      for (int p = 0; p < kMaxKT / 16; ++p) {
        if (p >= kp) break;
        const uint32_t a[4] = {p0.x, p0.y, p1.x, p1.y};
        uint32_t b[kChunk / 16][4];
#pragma unroll
        for (int d = 0; d < kChunk / 16; ++d)
#pragma unroll
          for (int r = 0; r < 4; ++r) b[d][r] = bn[d][r];
        if (p + 1 < kp) {
          p0 = sp[(k0 / 8 + p * 2 + 2) * 64 + 2 * lane];
          p1 = sp[(k0 / 8 + p * 2 + 3) * 64 + 2 * lane];
#pragma unroll
          for (int d = 0; d < kChunk / 16; ++d)
            if (2 * d < ndt)
              k2::ldsm_x4_t(bn[d], st + (p + 1) * 16 * kChunk + voff[d]);
        }
#pragma unroll
        for (int d = 0; d < kChunk / 16; ++d) {
          if (2 * d < ndt) {
            k2::mma(o[2 * d], a, b[d][0], b[d][1]);
            k2::mma(o[2 * d + 1], a, b[d][2], b[d][3]);
          }
        }
      }
      if (t == nkv - 1) {
        const int row = r0 + warp * 16 + (lane >> 2);
        bf16* ob = out + bh * n * hd;
#pragma unroll
        for (int d = 0; d < kChunk / 8; ++d) {
          const int col = c0 + d * 8 + (lane & 3) * 2;
          if (d >= ndt || col >= hd) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = row + h * 8;
            if (r >= n) continue;
            bf16* dst = ob + (size_t)r * hd + col;
            if (col + 1 < hd && (hd & 1) == 0) {
              *reinterpret_cast<uint32_t*>(dst) =
                  k2::pack(o[d][2 * h], o[d][2 * h + 1]);
            } else {
              dst[0] = __float2bfloat16_rn(o[d][2 * h]);
              if (col + 1 < hd) dst[1] = __float2bfloat16_rn(o[d][2 * h + 1]);
            }
          }
        }
      }
    }
    __syncwarp();   // the warp is done with this stage: release it
    if (lane == 0) k2::mbar_arrive(empty + job % kStages);
  }
}

// The block shape: the (warps, keys a stage) that keeps 8 warps resident
// on an SM, or as many as N allows, with the most warps a block (fewer
// K/V re-reads) and then the longest stages (fewer barriers).  A stage
// must hold at least one 16-key step of K rows (at KD = 64 a 16-key V
// stage holds only 14).
template <int KD>
FwdLayout<KD> fwd_layout(int n) {
  FwdLayout<KD> best{k2::round_up(n, 16), 0, 0};
  int best_score = 0;
  for (int w = kMaxWarps; w >= 1; w >>= 1) {
    for (int kt = kMaxKT; kt >= 16; kt -= 16) {
      const FwdLayout<KD> lay{best.np, w, kt};
      if (lay.ktk() < 16) continue;
      const int res = k2::warps_per_sm(w, lay.bytes());
      const int score = res == 0 ? 0 : min(res, 8) * 1000 + w * 100 + kt;
      if (score > best_score) {
        best = lay;
        best_score = score;
      }
    }
  }
  return best;
}

template <int KD>
int launch_mma(const void* q, const void* k, const void* v, void* out, int b,
               int h, int n, int hd, float scale, cudaStream_t stream) {
  static size_t reserved = 0;
  const FwdLayout<KD> lay = fwd_layout<KD>(n);
  if (lay.warps == 0 || lay.ktk() < 16) return (int)cudaErrorInvalidValue;
  cudaError_t err = k2::reserve_smem(
      reinterpret_cast<const void*>(attn_fwd_mma_kernel<KD>), lay.bytes(),
      &reserved);
  if (err != cudaSuccess) return (int)err;
  const int vec = ((reinterpret_cast<uintptr_t>(q) |
                    reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v)) % 16 == 0) &&
                  hd % 8 == 0;
  const int rows = lay.warps * 16;
  dim3 grid((n + rows - 1) / rows, h, b);
  attn_fwd_mma_kernel<KD><<<grid, (lay.warps + 1) * 32, lay.bytes(),
                            stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), n, hd, lay.kt,
      scale, vec);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- f32 ---

constexpr int kThreads = 256;
constexpr int kRowsPerPass = 8;
constexpr size_t kSmemLimit = 200 * 1024;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

int rows_per_block(int n, int kd) {
  int rows = 64;
  while (rows > 8 &&
         (size_t)rows * (n + kd) * sizeof(float) > kSmemLimit)
    rows >>= 1;
  return rows;
}

// one block per (tile of query rows, head, batch), the whole f32 score
// rows in shared memory, scalar FMAs
template <int KD>
__global__ void attn_fwd_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ out, int n, int hd,
                                int rows, float scale) {
  extern __shared__ __align__(16) float smem_f[];
  float* s = smem_f;                      // [rows, n] scores, then p
  float* qs = smem_f + (size_t)rows * n;  // [rows, KD]
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, n - r0);
  const float* qb = q + (bh * n + r0) * KD;
  const float* kb = k + bh * n * KD;
  const float* vb = v + bh * n * hd;
  float* ob = out + (bh * n + r0) * hd;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < nr * KD; idx += blockDim.x) qs[idx] = qb[idx];
  __syncthreads();

  // scores: one key column per thread, its key row held in registers
  for (int j = tid; j < n; j += blockDim.x) {
    float kr[KD];
#pragma unroll
    for (int d = 0; d < KD; ++d) kr[d] = kb[(size_t)j * KD + d];
    for (int r = 0; r < nr; ++r) {
      const float* qr = qs + r * KD;
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < KD; ++d) acc = fmaf(qr[d], kr[d], acc);
      s[(size_t)r * n + j] = acc * scale;
    }
  }
  __syncthreads();

  // two-pass softmax, one warp per row
  const int warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  for (int r = warp; r < nr; r += nwarps) {
    float* row = s + (size_t)r * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) row[j] /= sum;
  }
  __syncthreads();

  // PV: thread owns output column d for kRowsPerPass rows per pass
  const int groups = blockDim.x / hd;
  const int d = tid % hd;
  const int g = tid / hd;
  if (g < groups) {
    for (int rb = g * kRowsPerPass; rb < nr; rb += groups * kRowsPerPass) {
      float acc[kRowsPerPass];
#pragma unroll
      for (int u = 0; u < kRowsPerPass; ++u) acc[u] = 0.0f;
      for (int j = 0; j < n; ++j) {
        const float vv = vb[(size_t)j * hd + d];
#pragma unroll
        for (int u = 0; u < kRowsPerPass; ++u) {
          const int r = min(rb + u, nr - 1);
          acc[u] = fmaf(s[(size_t)r * n + j], vv, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsPerPass; ++u)
        if (rb + u < nr) ob[(size_t)(rb + u) * hd + d] = acc[u];
    }
  }
}

template <int KD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int b,
               int h, int n, int hd, float scale, cudaStream_t stream) {
  const int rows = rows_per_block(n, KD);
  const size_t smem = (size_t)rows * (n + KD) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + rows - 1) / rows, h, b);
  attn_fwd_kernel<KD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), n, hd, rows,
      scale);
  return (int)cudaGetLastError();
}

template <int KD>
int dispatch_dtype(const void* q, const void* k, const void* v, void* out,
                   int b, int h, int n, int hd, int dtype, float scale,
                   cudaStream_t stream) {
  if (dtype == 0) return launch_f32<KD>(q, k, v, out, b, h, n, hd, scale, stream);
  if (dtype == 1) return launch_mma<KD>(q, k, v, out, b, h, n, hd, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k [B, H, N, kd]; v, out [B, H, N, hd]; contiguous; dtype 0 = f32,
// 1 = bf16.  kd in {16, 32, 64}, 1 <= hd <= 256, 8 <= N <= 2048.
int cy_attention_fwd(const void* q, const void* k, const void* v, void* out,
                     int b, int h, int n, int kd, int hd, int dtype,
                     float scale, cudaStream_t stream) {
  if (hd < 1 || hd > kThreads || n < 1 || n > 2048)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return (int)cudaSuccess;
  switch (kd) {
    case 16: return dispatch_dtype<16>(q, k, v, out, b, h, n, hd, dtype, scale, stream);
    case 32: return dispatch_dtype<32>(q, k, v, out, b, h, n, hd, dtype, scale, stream);
    case 64: return dispatch_dtype<64>(q, k, v, out, b, h, n, hd, dtype, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
