// Fused C2PSA attention backward: dq, dk, dv of out = softmax(q k^T * s) v.
//
// Replaces caesar_yolo_tpu/models/pallas_attn.py's custom VJP
// (_attention_vjp_fwd / _attention_vjp_bwd), which recomputes the scores
// and differentiates _attention_ref.  The rounding points of that VJP in
// the compute type T (bf16 or f32) are kept:
//   p   = softmax(s) in f32, p_c = p rounded to T (as the forward);
//   dP  = dO v^T accumulated in f32, then rounded to T (JAX's transpose of
//         the PV product returns the probabilities' dtype);
//   dS  = p * (dP - rowsum(p * dP)) * scale, in f32 with the f32 p;
//   dq  = dS k, dk = dS^T q, dv = p_c^T dO, accumulated in f32 and rounded
//         once to T.
//
// Design, two launches:
//   1. one block per (tile of query rows, head, batch), as the forward: it
//      recomputes the tile's score rows into shared memory together with
//      their dP rows, softmaxes each row (one warp per row), forms dS and
//      dq, and writes dS and p_c to an f32 scratch [B, H, N, N];
//   2. one block per (tile of 32 key rows, head, batch): dk and dv from
//      that scratch, the query rows streamed through shared memory in
//      chunks of 32.
// Scalar FMAs throughout; tensor-core MMA is later work.
//
// Bound on an H100 at yolo11l@640 training (B=16, H=4, N=400, kd=32,
// hd=64, bf16): q, k, v, dO read and dq, dk, dv written once are 16.4 MB
// (4.9 us at 3.35 TB/s) against 2*B*H*N^2*(3*kd + 2*hd) = 4.6 GFLOP (4.6 us
// at the bf16 tensor-core peak): the bytes bound it, narrowly.  The
// scratch adds 2 x 41 MB written and read once, which this design pays on
// top.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerPass = 8;
constexpr size_t kSmemLimit = 200 * 1024;
constexpr int kChunkD = 32;   // head-width chunk of the dP pass
constexpr int kCols = 32;     // key rows per block of the dk/dv launch
constexpr int kChunkI = 32;   // query rows per shared-memory chunk there
constexpr int kDvWidth = 64;  // dv columns per pass there

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <typename T, int KD>
__global__ void attn_bwd_dq_kernel(const T* __restrict__ q,
                                   const T* __restrict__ k,
                                   const T* __restrict__ v,
                                   const T* __restrict__ dout,
                                   T* __restrict__ dq, float* __restrict__ ds_g,
                                   float* __restrict__ pc_g, int n, int hd,
                                   int rows, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int hdp = padded(hd);
  float* p = smem;                          // [rows, n] scores, then p (f32)
  float* dp = p + (size_t)rows * n;         // [rows, n] dP, then dS
  float* qs = dp + (size_t)rows * n;        // [rows, KD]
  float* dos = qs + (size_t)rows * KD;      // [rows, hdp], zero padded
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, n - r0);
  const T* qb = q + (bh * n + r0) * KD;
  const T* kb = k + bh * n * KD;
  const T* vb = v + bh * n * hd;
  const T* dob = dout + (bh * n + r0) * hd;
  T* dqb = dq + (bh * n + r0) * KD;
  float* dsb = ds_g + (bh * n + r0) * (size_t)n;
  float* pcb = pc_g + (bh * n + r0) * (size_t)n;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < nr * KD; idx += blockDim.x) qs[idx] = to_f(qb[idx]);
  for (int idx = tid; idx < rows * hdp; idx += blockDim.x) {
    const int r = idx / hdp, d = idx % hdp;
    dos[idx] = (r < nr && d < hd) ? to_f(dob[(size_t)r * hd + d]) : 0.0f;
  }
  __syncthreads();

  // scores and dP: one key column per thread, its key row in registers,
  // its value row in chunks of kChunkD
  for (int j = tid; j < n; j += blockDim.x) {
    float kr[KD];
#pragma unroll
    for (int d = 0; d < KD; ++d) kr[d] = to_f(kb[(size_t)j * KD + d]);
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
        vr[dd] = d0 + dd < hd ? to_f(vb[(size_t)j * hd + d0 + dd]) : 0.0f;
      for (int r = 0; r < nr; ++r) {
        const float* dr = dos + (size_t)r * hdp + d0;
        float acc = 0.0f;
#pragma unroll
        for (int dd = 0; dd < kChunkD; ++dd) acc = fmaf(dr[dd], vr[dd], acc);
        dp[(size_t)r * n + j] += acc;
      }
    }
    for (int r = 0; r < nr; ++r)
      dp[(size_t)r * n + j] = to_f(from_f<T>(dp[(size_t)r * n + j]));
  }
  __syncthreads();

  // per row (one warp): softmax as the forward, p_c, rowsum(p dP), dS
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
      pcb[(size_t)r * n + j] = to_f(from_f<T>(pj));
      dot = fmaf(pj, dprow[j], dot);
    }
    dot = warp_sum(dot);
    for (int j = lane; j < n; j += 32) {
      const float ds = prow[j] * (dprow[j] - dot) * scale;
      dprow[j] = ds;
      dsb[(size_t)r * n + j] = ds;
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
        const float kk = to_f(kb[(size_t)j * KD + d]);
#pragma unroll
        for (int u = 0; u < kRowsPerPass; ++u) {
          const int r = min(rb + u, nr - 1);
          acc[u] = fmaf(dp[(size_t)r * n + j], kk, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsPerPass; ++u)
        if (rb + u < nr) dqb[(size_t)(rb + u) * KD + d] = from_f<T>(acc[u]);
    }
  }
}

template <typename T, int KD>
__global__ void attn_bwd_dkdv_kernel(const T* __restrict__ q,
                                     const T* __restrict__ dout,
                                     const float* __restrict__ ds_g,
                                     const float* __restrict__ pc_g,
                                     T* __restrict__ dk, T* __restrict__ dv,
                                     int n, int hd) {
  __shared__ float sa[kChunkI * kCols];  // dS or p_c chunk [i, j]
  __shared__ float sb[kChunkI * 64];     // q chunk [i, KD] or dO [i, 64]
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int j0 = blockIdx.x * kCols;
  const int nc = min(kCols, n - j0);
  const int tid = threadIdx.x;
  const float* dsb = ds_g + bh * n * (size_t)n;
  const float* pcb = pc_g + bh * n * (size_t)n;
  const T* qb = q + bh * n * KD;
  const T* dob = dout + bh * n * hd;

  // dk = dS^T q
  constexpr int kPerDk = kCols * KD / kThreads;
  float acc[kPerDk];
#pragma unroll
  for (int u = 0; u < kPerDk; ++u) acc[u] = 0.0f;
  for (int i0 = 0; i0 < n; i0 += kChunkI) {
    const int ni = min(kChunkI, n - i0);
    for (int idx = tid; idx < kChunkI * kCols; idx += kThreads) {
      const int ii = idx / kCols, jj = idx % kCols;
      sa[idx] = (ii < ni && jj < nc)
                    ? dsb[(size_t)(i0 + ii) * n + j0 + jj] : 0.0f;
    }
    for (int idx = tid; idx < kChunkI * KD; idx += kThreads) {
      const int ii = idx / KD, d = idx % KD;
      sb[idx] = ii < ni ? to_f(qb[(size_t)(i0 + ii) * KD + d]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPerDk; ++u) {
      const int o = tid + u * kThreads;
      const int jj = o / KD, d = o % KD;
      for (int ii = 0; ii < kChunkI; ++ii)
        acc[u] = fmaf(sa[ii * kCols + jj], sb[ii * KD + d], acc[u]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < kPerDk; ++u) {
    const int o = tid + u * kThreads;
    const int jj = o / KD, d = o % KD;
    if (jj < nc) dk[(bh * n + j0 + jj) * KD + d] = from_f<T>(acc[u]);
  }

  // dv = p_c^T dO, kDvWidth columns per pass
  constexpr int kPerDv = kCols * kDvWidth / kThreads;
  for (int e0 = 0; e0 < hd; e0 += kDvWidth) {
    float acc2[kPerDv];
#pragma unroll
    for (int u = 0; u < kPerDv; ++u) acc2[u] = 0.0f;
    for (int i0 = 0; i0 < n; i0 += kChunkI) {
      const int ni = min(kChunkI, n - i0);
      for (int idx = tid; idx < kChunkI * kCols; idx += kThreads) {
        const int ii = idx / kCols, jj = idx % kCols;
        sa[idx] = (ii < ni && jj < nc)
                      ? pcb[(size_t)(i0 + ii) * n + j0 + jj] : 0.0f;
      }
      for (int idx = tid; idx < kChunkI * kDvWidth; idx += kThreads) {
        const int ii = idx / kDvWidth, e = idx % kDvWidth;
        sb[idx] = (ii < ni && e0 + e < hd)
                      ? to_f(dob[(size_t)(i0 + ii) * hd + e0 + e]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kPerDv; ++u) {
        const int o = tid + u * kThreads;
        const int jj = o / kDvWidth, e = o % kDvWidth;
        for (int ii = 0; ii < kChunkI; ++ii)
          acc2[u] = fmaf(sa[ii * kCols + jj], sb[ii * kDvWidth + e], acc2[u]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < kPerDv; ++u) {
      const int o = tid + u * kThreads;
      const int jj = o / kDvWidth, e = o % kDvWidth;
      if (jj < nc && e0 + e < hd)
        dv[(bh * n + j0 + jj) * hd + e0 + e] = from_f<T>(acc2[u]);
    }
  }
}

template <typename T, int KD>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, float* ds, float* pc, int b, int h,
           int n, int hd, float scale, cudaStream_t stream) {
  const int rows = rows_per_block(n, KD, hd);
  const size_t smem = (size_t)rows * (2 * n + KD + padded(hd)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<T, KD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid1((n + rows - 1) / rows, h, b);
  attn_bwd_dq_kernel<T, KD><<<grid1, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<T*>(dq), ds, pc, n, hd, rows, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid2((n + kCols - 1) / kCols, h, b);
  attn_bwd_dkdv_kernel<T, KD><<<grid2, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(dout), ds, pc,
      static_cast<T*>(dk), static_cast<T*>(dv), n, hd);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_kd(const void* q, const void* k, const void* v, const void* dout,
                void* dq, void* dk, void* dv, float* ds, float* pc, int b,
                int h, int n, int kd, int hd, float scale,
                cudaStream_t stream) {
  switch (kd) {
    case 16: return launch<T, 16>(q, k, v, dout, dq, dk, dv, ds, pc, b, h, n, hd, scale, stream);
    case 32: return launch<T, 32>(q, k, v, dout, dq, dk, dv, ds, pc, b, h, n, hd, scale, stream);
    case 64: return launch<T, 64>(q, k, v, dout, dq, dk, dv, ds, pc, b, h, n, hd, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, dq, dk [B, H, N, kd]; v, dout, dv [B, H, N, hd]; ds, pc f32
// scratch [B, H, N, N]; all contiguous; dtype 0 = f32, 1 = bf16.
// kd in {16, 32, 64}, 1 <= hd <= 256, N <= 2048.
int cy_attention_bwd(const void* q, const void* k, const void* v,
                     const void* dout, void* dq, void* dk, void* dv,
                     float* ds, float* pc, int b, int h, int n, int kd, int hd,
                     int dtype, float scale, cudaStream_t stream) {
  if (hd < 1 || hd > 256 || n < 1 || n > 2048)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return (int)cudaSuccess;
  if (dtype == 0)
    return dispatch_kd<float>(q, k, v, dout, dq, dk, dv, ds, pc, b, h, n, kd,
                              hd, scale, stream);
  if (dtype == 1)
    return dispatch_kd<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, ds, pc, b, h,
                                      n, kd, hd, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
