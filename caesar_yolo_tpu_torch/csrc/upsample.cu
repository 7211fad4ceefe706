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
//   backward: the incoming gradient is read where it lies, through its
//             batch, row and pixel strides with its channels contiguous:
//             in the YOLO neck the upsample's output goes into torch.cat,
//             so the gradient is a channel slice of the concat's
//             channels_last gradient, which a copy would cost more than
//             the kernel.  Each thread makes one 16-byte (or narrower,
//             ops/cuda_upsample.py:backward_plan) vector of gx from four
//             loads of the 2x2 window, each lane summed in f32 in the
//             fixed order ((g00 + g01) + g10) + g11 and rounded once (the
//             plain version sums in the same order: bit-equal); rows of
//             gx map to the grid, so no thread divides in 64 bits.
//
// Bound on an H100: bytes.  Forward reads the input once and writes 4x
// its bytes; backward reads 4x and writes 1x.  At yolo11l@640 training
// (B=16, bf16) the two neck upsamples take [16,512,20,20] and
// [16,512,40,40] and move 32.8 MB and 131 MB each way: 9.8 us and 39.1 us
// at 3.35 TB/s.
#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// the backward's vectors a thread and threads a block: every configuration
// of 1 or 2 vectors x 128-512 threads measured within noise on an H100
// (PERF.md)
constexpr int kBwdWindows = 2;
constexpr int kBwdThreads = 256;

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

// the raw vector of VB bytes
template <int VB>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<2> {
  using type = unsigned short;
};

// a lane's value in f32 and back: S is float, or unsigned short holding
// bf16 bits
__device__ __forceinline__ float lane_f(float v) { return v; }
__device__ __forceinline__ float lane_f(unsigned short v) {
  return __uint_as_float((unsigned)v << 16);
}
template <typename S>
__device__ __forceinline__ S lane_from(float f);
template <>
__device__ __forceinline__ float lane_from<float>(float f) {
  return f;
}
template <>
__device__ __forceinline__ unsigned short lane_from<unsigned short>(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// Grid (B*H rows of gx, column blocks).  A thread takes kBwdWindows vectors
// of one gx row, each VB bytes of one output pixel's channels: pixel t / cv,
// vector t % cv of the row's W*cv, t strided by the block.  gy is read
// where it lies through its batch, row and pixel strides (elements), its
// channels contiguous: four VB-byte loads of the 2x2 window, each lane
// summed in f32 as ((g00 + g01) + g10) + g11 and rounded once.
template <typename S, int VB>
__global__ void __launch_bounds__(kBwdThreads)
up2_bwd_kernel(const S* __restrict__ gy, S* __restrict__ gx, int h, int w,
               int cv, long long sb, long long sh, long long sw) {
  using V = typename Raw<VB>::type;
  constexpr int L = VB / (int)sizeof(S);
  const int row = blockIdx.x;
  const int b = row / h, y = row - b * h;
  const int per_row = w * cv;
  const S* src = gy + b * sb + (long long)(2 * y) * sh;
  V* dst = reinterpret_cast<V*>(gx) + (size_t)row * per_row;
  V in[kBwdWindows][4];
  int t[kBwdWindows];
#pragma unroll
  for (int k = 0; k < kBwdWindows; ++k) {
    t[k] = (blockIdx.y * kBwdWindows + k) * kBwdThreads + threadIdx.x;
    if (t[k] < per_row) {
      const int xo = t[k] / cv, c = t[k] - xo * cv;
      const S* p0 = src + (long long)(2 * xo) * sw + c * L;
      in[k][0] = __ldg(reinterpret_cast<const V*>(p0));
      in[k][1] = __ldg(reinterpret_cast<const V*>(p0 + sw));
      in[k][2] = __ldg(reinterpret_cast<const V*>(p0 + sh));
      in[k][3] = __ldg(reinterpret_cast<const V*>(p0 + sh + sw));
    }
  }
#pragma unroll
  for (int k = 0; k < kBwdWindows; ++k) {
    if (t[k] >= per_row) continue;
    S e[4][L], o[L];
#pragma unroll
    for (int j = 0; j < 4; ++j) memcpy(e[j], &in[k][j], VB);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float s = lane_f(e[0][l]) + lane_f(e[1][l]);
      s = s + lane_f(e[2][l]);
      s = s + lane_f(e[3][l]);
      o[l] = lane_from<S>(s);
    }
    V v;
    memcpy(&v, o, VB);
    dst[t[k]] = v;
  }
}

template <typename S, int VB>
int launch_bwd(const void* gy, void* gx, int b, int h, int w, int c,
               long long sb, long long sh, long long sw,
               cudaStream_t stream) {
  const int cv = c * (int)sizeof(S) / VB;
  constexpr long long per_block = (long long)kBwdThreads * kBwdWindows;
  const long long cols = ((long long)w * cv + per_block - 1) / per_block;
  if (cols > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(b * h), (unsigned)cols);
  up2_bwd_kernel<S, VB><<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const S*>(gy), static_cast<S*>(gx), h, w, cv, sb, sh, sw);
  return (int)cudaGetLastError();
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

// gy [B, C, 2H, 2W] with channel stride 1, read where it lies at batch,
// row and pixel strides sb, sh, sw (elements; gy points at its first
// element) -> gx [B, H, W, C] contiguous (channels_last); dtype 0 = f32,
// 1 = bf16.  vec_bytes (16, 8, 4 or 2, at least the element) must divide
// C's bytes, gy's and gx's addresses and every stride's bytes.
int cy_upsample2x_bwd(const void* gy, void* gx, int b, int h, int w, int c,
                      long long sb, long long sh, long long sw, int dtype,
                      int vec_bytes, cudaStream_t stream) {
  if ((long long)b * h * w * c == 0) return (int)cudaSuccess;
  const int size = dtype == 0 ? 4 : 2;
  const long long vb = vec_bytes;
  if ((dtype != 0 && dtype != 1) || vb < size || vb > 16 || (vb & (vb - 1)) ||
      (c * size) % vb || ((sb * size) | (sh * size) | (sw * size)) % vb ||
      ((reinterpret_cast<uintptr_t>(gy) | reinterpret_cast<uintptr_t>(gx)) %
       vb) ||
      (long long)b * h > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    switch (vec_bytes) {
      case 16:
        return launch_bwd<float, 16>(gy, gx, b, h, w, c, sb, sh, sw, stream);
      case 8:
        return launch_bwd<float, 8>(gy, gx, b, h, w, c, sb, sh, sw, stream);
      default:
        return launch_bwd<float, 4>(gy, gx, b, h, w, c, sb, sh, sw, stream);
    }
  }
  switch (vec_bytes) {
    case 16:
      return launch_bwd<unsigned short, 16>(gy, gx, b, h, w, c, sb, sh,
                                            sw, stream);
    case 8:
      return launch_bwd<unsigned short, 8>(gy, gx, b, h, w, c, sb, sh,
                                           sw, stream);
    case 4:
      return launch_bwd<unsigned short, 4>(gy, gx, b, h, w, c, sb, sh,
                                           sw, stream);
    default:
      return launch_bwd<unsigned short, 2>(gy, gx, b, h, w, c, sb, sh,
                                           sw, stream);
  }
}

}  // extern "C"
