// int8 convolution of the PTQ path (kernel K9): quantize the input on load,
// s8 x s8 -> s32 on the tensor cores, fused dequantize, bias and SiLU.
//
// Replaces no Pallas kernel: the JAX package's int8 branch
// (caesar_yolo_tpu/models/layers.py:139-149, Conv.__call__ with "wq") is
// plain XLA, which compiled the s8 convolution and its epilogue unaided.
// PyTorch has no int8 convolution on CUDA, and im2col + torch._int_mm would
// write the unfolded int8 input (about 1.9 GB for one 3x3 conv over 256
// channels at 160x160, batch 32) and take four more passes for the
// quantize, dequantize, bias and SiLU.  The function, per output element:
//
//   xq  = clip(rint(x / xs), -127, 127)            (0 at padding)
//   acc = sum over (r, s, c) of xq[oy*st - pad + r, ox*st - pad + s, c]
//                              * wq[n, r, s, c]     (int32, exact)
//   y   = T(float(acc) * (ws[n] * xs) + b[n])       (each op rounded)
//   out = act ? T(y / (1 + expf(-y))) : y            (F.silu's form)
//
// held bit for bit to models/cuda_qconv.py:qconv_plain.  Every float op is
// an explicit _rn intrinsic, so FMA contraction cannot fold the
// dequantize; the division of the quantize goes through divide::div_rn
// (IEEE-rounded, without the compiler's per-call branches).
//
// Design (a first version, right before fast): an implicit GEMM with
// M = B*Ho*Wo output pixels, N = cout and K = kh*kw*cin taken in steps of
// 32 (the tail zero-filled).  A block owns a 128 x 64 tile of the output
// and 8 warps of 32 x 32; per K step its threads gather the 128 x 32 input
// slice element by element through the input's strides (any layout; the
// port's activations are channels_last or channel slices of it),
// quantize it into shared memory, copy the 64 x 32 weight slice from the
// pre-laid-out [cout][kh][kw][cin] int8 weights, and each warp issues
// mma.sync.m16n8k32 s8 (2 x 4 of them).  Shared rows are padded to 48
// bytes so the fragment loads hit 32 distinct banks.  The epilogue writes
// the channels_last output, which is [M][N] row-major.
//
// Bound on an H100: operations at the large 3x3 layers (2*M*N*K int8 ops
// against 1979 TOPS), bytes at the 1x1 ones.  Not yet redesigned: wgmma
// with TMA-fed tiles, and the input quantized once per layer instead of
// once per (tile, K step).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "divide.cuh"

namespace {

constexpr int kBM = 128;     // output pixels a block
constexpr int kBN = 64;      // output channels a block
constexpr int kBK = 32;      // K a step (one m16n8k32)
constexpr int kRow = 48;     // shared bytes a tile row (32 used)
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// clip(rint(v / xs), -127, 127) as a byte
__device__ __forceinline__ uint32_t quantize(float v, divide::Divisor d) {
  float q = rintf(divide::div_rn(v, d));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)(int)q;
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Shape {
  long long sn, sc, sh, sw;  // input strides (elements)
  long long m;               // B * ho * wo
  int h, w, cin, cout, k, stride, pad, ho, wo, ktot, act;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
qconv_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
             const float* __restrict__ ws, const float* __restrict__ xs_ptr,
             const float* __restrict__ bias, T* __restrict__ y, Shape p) {
  __shared__ __align__(16) uint8_t as[kBM * kRow];
  __shared__ __align__(16) uint8_t bs[kBN * kRow];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const float xs = *xs_ptr;
  const divide::Divisor dv = divide::make_divisor(xs);

  // the input row this thread gathers: output pixel m0 + arow, K half ah
  const int arow = tid >> 1, ahalf = tid & 1;
  const long long am = m0 + arow;
  const bool arow_ok = am < p.m;
  int iy0 = 0, ix0 = 0;
  const T* xb = x;
  if (arow_ok) {
    const long long hw = (long long)p.ho * p.wo;
    const long long img = am / hw;
    const int rem = (int)(am - img * hw);
    iy0 = (rem / p.wo) * p.stride - p.pad;
    ix0 = (rem % p.wo) * p.stride - p.pad;
    xb = x + img * p.sn;
  }
  // the weight row and 8-byte part this thread copies
  const int brow = tid >> 2, bpart = tid & 3;
  const int bn = n0 + brow;
  const int kw_cin = p.k * p.cin;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int l = 0; l < 4; ++l) acc[i][j][l] = 0;

  for (int k0 = 0; k0 < p.ktot; k0 += kBK) {
    // A: 16 quantized inputs, K = k0 + 16 * ahalf ...
    {
      int kk = k0 + 16 * ahalf;
      int r = kk / kw_cin;
      const int rem = kk - r * kw_cin;
      int s = rem / p.cin;
      int c = rem - s * p.cin;
      uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        uint32_t q = 0u;
        if (arow_ok && kk + j < p.ktot) {
          const int iy = iy0 + r, ix = ix0 + s;
          if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w)
            q = quantize(to_f32(xb[iy * p.sh + ix * p.sw + c * p.sc]), dv);
        }
        words[j >> 2] |= q << (8 * (j & 3));
        if (++c == p.cin) {
          c = 0;
          if (++s == p.k) {
            s = 0;
            ++r;
          }
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(as + arow * kRow + 16 * ahalf);
      *dst = make_uint4(words[0], words[1], words[2], words[3]);
    }
    // B: 8 weight bytes, K = k0 + 8 * bpart ...
    {
      const int kk = k0 + 8 * bpart;
      uint32_t words[2] = {0u, 0u};
      if (bn < p.cout) {
        const int8_t* src = wq + (long long)bn * p.ktot;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (kk + j < p.ktot)
            words[j >> 2] |= (uint32_t)(uint8_t)src[kk + j] << (8 * (j & 3));
      }
      uint2* dst = reinterpret_cast<uint2*>(bs + brow * kRow + 8 * bpart);
      *dst = make_uint2(words[0], words[1]);
    }
    __syncthreads();

    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint8_t* ra = as + (warp_m * 32 + i * 16 + g) * kRow + 4 * t;
      a[i][0] = *reinterpret_cast<const uint32_t*>(ra);
      a[i][1] = *reinterpret_cast<const uint32_t*>(ra + 8 * kRow);
      a[i][2] = *reinterpret_cast<const uint32_t*>(ra + 16);
      a[i][3] = *reinterpret_cast<const uint32_t*>(ra + 8 * kRow + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint8_t* rb = bs + (warp_n * 32 + j * 8 + g) * kRow + 4 * t;
      b[j][0] = *reinterpret_cast<const uint32_t*>(rb);
      b[j][1] = *reinterpret_cast<const uint32_t*>(rb + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    __syncthreads();
  }

  // epilogue: c0, c1 at row g, c2, c3 at row g + 8; columns 2t, 2t + 1
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const long long m = m0 + warp_m * 32 + i * 16 + g + (l >> 1) * 8;
        const int n = n0 + warp_n * 32 + j * 8 + 2 * t + (l & 1);
        if (m >= p.m || n >= p.cout) continue;
        const float scale = __fmul_rn(ws[n], xs);
        const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][l]),
                                            scale), bias[n]);
        T out = from_f32<T>(v);
        if (p.act) {
          const float u = to_f32(out);
          out = from_f32<T>(__fdiv_rn(u, __fadd_rn(1.0f, expf(-u))));
        }
        y[m * p.cout + n] = out;
      }
}

template <typename T>
int launch(const void* x, const void* wq, const void* ws, const void* xs,
           const void* bias, void* y, const Shape& p, cudaStream_t stream) {
  const dim3 grid((unsigned)((p.m + kBM - 1) / kBM),
                  (unsigned)((p.cout + kBN - 1) / kBN));
  qconv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(ws), static_cast<const float*>(xs),
      static_cast<const float*>(bias), static_cast<T*>(y), p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, cin, H, W] read through its element strides (sn, sc, sh, sw);
// wq int8 [cout][k][k][cin] contiguous; ws, bias f32 [cout]; xs f32 [1] on
// the device; y [B, Ho, Wo, cout] contiguous (channels_last), the input's
// dtype (0 = f32, 1 = bf16).  k in {1, 3}, stride in {1, 2}, pad = k / 2;
// K = k*k*cin must keep 127 * 127 * K below 2^31 (exact int32 sums).
int cy_qconv(const void* x, int dtype, int b, int cin, int h, int w,
             long long sn, long long sc, long long sh, long long sw,
             const void* wq, const void* ws, const void* xs,
             const void* bias, void* y, int cout, int k, int stride,
             int pad, int act, cudaStream_t stream) {
  if ((k != 1 && k != 3) || (stride != 1 && stride != 2) || pad != k / 2 ||
      b < 0 || cin < 1 || cout < 1 || h < 1 || w < 1 || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  Shape p;
  p.sn = sn;
  p.sc = sc;
  p.sh = sh;
  p.sw = sw;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cout = cout;
  p.k = k;
  p.stride = stride;
  p.pad = pad;
  p.ho = (h + 2 * pad - k) / stride + 1;
  p.wo = (w + 2 * pad - k) / stride + 1;
  p.ktot = k * k * cin;
  p.act = act;
  p.m = (long long)b * p.ho * p.wo;
  if ((long long)p.ktot * 127 * 127 >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (p.m == 0) return (int)cudaSuccess;
  return dtype == 0 ? launch<float>(x, wq, ws, xs, bias, y, p, stream)
                    : launch<__nv_bfloat16>(x, wq, ws, xs, bias, y, p, stream);
}

}  // extern "C"
