// 2x nearest-neighbour upsample and its gradient, channels_last memory.
//
// Replaces caesar_yolo_tpu/ops/pallas_upsample.py:upsample2x_pallas
// (_up2_kernel), which replicates each pixel in VMEM and touches HBM once
// each way.  The JAX package had no gradient for it; the backward here is
// the transpose of the broadcast form it replaced (layers.py:475-477).
//
// Layout: x is [B, C, H, W] in channels_last memory, i.e. [B, H, W, C] in
// memory, and y is [B, 2H, 2W, C] in memory.
//   forward:  each thread copies one 16-byte (or narrower, when a pixel's
//             bytes are not a multiple of 16) vector of one input pixel's
//             channels to the four output pixels it covers; a pure copy,
//             so any dtype and bit-equal to the broadcast form.
//   backward: each thread sums one channel of one 2x2 window of the
//             incoming gradient in f32, in the fixed order
//             ((g00 + g01) + g10) + g11, and rounds once to the dtype;
//             the plain version sums in the same order (bit-equal).
//
// Bound on an H100: bytes.  Forward reads the input once and writes 4x
// its bytes; backward reads 4x and writes 1x.  At yolo11l@640 training
// (B=16, bf16) the two neck upsamples take [16,512,20,20] and
// [16,512,40,40] and move 32.8 MB and 131 MB each way: 9.8 us and 39.1 us
// at 3.35 TB/s.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
__global__ void up2_fwd_kernel(const V* __restrict__ x, V* __restrict__ y,
                               int h, int w, int cv, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % cv);
  const long long pix = i / cv;
  const int xw = (int)(pix % w);
  const long long t = pix / w;
  const int yh = (int)(t % h);
  const long long b = t / h;
  const V val = x[i];
  const long long o0 = ((b * 2 * h + 2 * yh) * 2 * w + 2 * xw) * cv + c;
  const long long o1 = o0 + (long long)2 * w * cv;
  y[o0] = val;
  y[o0 + cv] = val;
  y[o1] = val;
  y[o1 + cv] = val;
}

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

template <typename T>
__global__ void up2_bwd_kernel(const T* __restrict__ gy, T* __restrict__ gx,
                               int h, int w, int c, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int cc = (int)(i % c);
  const long long pix = i / c;
  const int xw = (int)(pix % w);
  const long long t = pix / w;
  const int yh = (int)(t % h);
  const long long b = t / h;
  const long long o0 = ((b * 2 * h + 2 * yh) * 2 * w + 2 * xw) * c + cc;
  const long long o1 = o0 + (long long)2 * w * c;
  float s = to_f(gy[o0]) + to_f(gy[o0 + c]);
  s = s + to_f(gy[o1]);
  s = s + to_f(gy[o1 + c]);
  gx[i] = from_f<T>(s);
}

template <typename V>
int launch_fwd(const void* x, void* y, int b, int h, int w, int pixel_bytes,
               cudaStream_t stream) {
  const int cv = pixel_bytes / (int)sizeof(V);
  const long long total = (long long)b * h * w * cv;
  const long long blocks = (total + kThreads - 1) / kThreads;
  up2_fwd_kernel<V><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(x), static_cast<V*>(y), h, w, cv, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, H, W, pixel_bytes] bytes -> y [B, 2H, 2W, pixel_bytes]; both
// 16-byte aligned.  pixel_bytes must be even.
int cy_upsample2x_fwd(const void* x, void* y, int b, int h, int w,
                      int pixel_bytes, cudaStream_t stream) {
  if (pixel_bytes < 2 || pixel_bytes % 2) return (int)cudaErrorInvalidValue;
  if ((long long)b * h * w == 0) return (int)cudaSuccess;
  if (pixel_bytes % 16 == 0)
    return launch_fwd<uint4>(x, y, b, h, w, pixel_bytes, stream);
  if (pixel_bytes % 8 == 0)
    return launch_fwd<uint2>(x, y, b, h, w, pixel_bytes, stream);
  if (pixel_bytes % 4 == 0)
    return launch_fwd<unsigned int>(x, y, b, h, w, pixel_bytes, stream);
  return launch_fwd<unsigned short>(x, y, b, h, w, pixel_bytes, stream);
}

// gy [B, 2H, 2W, C] -> gx [B, H, W, C]; dtype 0 = f32, 1 = bf16.
int cy_upsample2x_bwd(const void* gy, void* gx, int b, int h, int w, int c,
                      int dtype, cudaStream_t stream) {
  const long long total = (long long)b * h * w * c;
  if (total == 0) return (int)cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (dtype == 0) {
    up2_bwd_kernel<float><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(gy), static_cast<float*>(gx), h, w, c, total);
  } else if (dtype == 1) {
    up2_bwd_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(gy), static_cast<__nv_bfloat16*>(gx),
        h, w, c, total);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
