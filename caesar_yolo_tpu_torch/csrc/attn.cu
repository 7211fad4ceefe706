// Fused C2PSA attention forward: out = softmax(q k^T * scale) v.
//
// Replaces caesar_yolo_tpu/models/pallas_attn.py:attention_pallas
// (_attn_kernel), which keeps each (batch, head)'s [N, N] f32 score
// matrix in VMEM.
//
// Design: one block per (tile of query rows, head, batch).  The block
// keeps the WHOLE f32 score row of each of its query rows in shared
// memory (rows * N * 4 bytes; the row tile shrinks from 64 to 16 rows so
// that N up to 2048 fits in the 227 KB a block may use), and softmaxes it
// in two passes: max, then exp and sum, then a divide.  The probability
// is rounded to the compute type AFTER normalising, exactly as the
// reference does (pallas_attn.py:63-68) -- an online softmax with
// deferred normalisation would round p differently in bf16.  Scores are
// f32 dot products multiplied by `scale` after the dot; the PV product
// accumulates in f32.  Scalar FMAs throughout: tensor-core MMA is later
// work.
//
// Bound on an H100 at yolo11l@640, B=32: 2*B*H*N^2*(kd+hd) = 3.9 GFLOP
// and 19.7 MB of q/k/v/out in bf16.  At the bf16 tensor-core peak
// (989 TFLOP/s) that is ~4 us of arithmetic against ~5.9 us of memory
// (3.35 TB/s), so the bound is the bytes; this scalar version runs far
// above it.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerPass = 8;
constexpr size_t kSmemLimit = 200 * 1024;

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

int rows_per_block(int n, int kd) {
  int rows = 64;
  while (rows > 8 &&
         (size_t)rows * (n + kd) * sizeof(float) > kSmemLimit)
    rows >>= 1;
  return rows;
}

template <typename T, int KD>
__global__ void attn_fwd_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v, T* __restrict__ out,
                                int n, int hd, int rows, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* s = smem;                 // [rows, n] scores, then probabilities
  float* qs = smem + (size_t)rows * n;  // [rows, KD]
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, n - r0);
  const T* qb = q + (bh * n + r0) * KD;
  const T* kb = k + bh * n * KD;
  const T* vb = v + bh * n * hd;
  T* ob = out + (bh * n + r0) * hd;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < nr * KD; idx += blockDim.x) qs[idx] = to_f(qb[idx]);
  __syncthreads();

  // scores: one key column per thread, its key row held in registers
  for (int j = tid; j < n; j += blockDim.x) {
    float kr[KD];
#pragma unroll
    for (int d = 0; d < KD; ++d) kr[d] = to_f(kb[(size_t)j * KD + d]);
    for (int r = 0; r < nr; ++r) {
      const float* qr = qs + r * KD;
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < KD; ++d) acc = fmaf(qr[d], kr[d], acc);
      s[(size_t)r * n + j] = acc * scale;
    }
  }
  __syncthreads();

  // two-pass softmax, one warp per row; p normalised, then rounded to T
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
    for (int j = lane; j < n; j += 32) row[j] = to_f(from_f<T>(row[j] / sum));
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
        const float vv = to_f(vb[(size_t)j * hd + d]);
#pragma unroll
        for (int u = 0; u < kRowsPerPass; ++u) {
          const int r = min(rb + u, nr - 1);
          acc[u] = fmaf(s[(size_t)r * n + j], vv, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsPerPass; ++u)
        if (rb + u < nr) ob[(size_t)(rb + u) * hd + d] = from_f<T>(acc[u]);
    }
  }
}

template <typename T, int KD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int h, int n, int hd, float scale, cudaStream_t stream) {
  const int rows = rows_per_block(n, KD);
  const size_t smem = (size_t)rows * (n + KD) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T, KD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + rows - 1) / rows, h, b);
  attn_fwd_kernel<T, KD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n, hd, rows, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_kd(const void* q, const void* k, const void* v, void* out, int b,
                int h, int n, int kd, int hd, float scale,
                cudaStream_t stream) {
  switch (kd) {
    case 16: return launch<T, 16>(q, k, v, out, b, h, n, hd, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, b, h, n, hd, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, b, h, n, hd, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k [B, H, N, kd]; v, out [B, H, N, hd]; contiguous; dtype 0 = f32,
// 1 = bf16.  kd in {16, 32, 64}, 1 <= hd <= 256, N <= 2048.
int cy_attention_fwd(const void* q, const void* k, const void* v, void* out,
                     int b, int h, int n, int kd, int hd, int dtype,
                     float scale, cudaStream_t stream) {
  if (hd < 1 || hd > kThreads || n < 1 || n > 2048)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0) return (int)cudaSuccess;
  if (dtype == 0)
    return dispatch_kd<float>(q, k, v, out, b, h, n, kd, hd, scale, stream);
  if (dtype == 1)
    return dispatch_kd<__nv_bfloat16>(q, k, v, out, b, h, n, kd, hd, scale,
                                      stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
