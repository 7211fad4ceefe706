// The bf16 conv epilogue of inference (kernel K10): y * scale + shift in
// f32, one rounding to bf16, then the reference's SiLU.
//
// Replaces no Pallas kernel: the JAX package's inference conv
// (caesar_yolo_tpu/models/layers.py:159-184, Conv2dRaw :213-216) emits
// f32, adds its f32 bias or applies BN in f32, casts once and applies
// `silu`, and XLA fused that into the conv's epilogue unaided.  The port's
// conv is cuDNN's f32 conv of the bf16 operands (models/layers.py:
// conv_f32); this kernel is the rest, one pass instead of PyTorch's three
// to five (a mixed-dtype add, a cast, SiLU's four ops).  Per element of
// the channels_last f32 input, channel ch:
//
//   v   = y * scale[ch] + shift[ch]     (f32, each op rounded; no scale
//                                        for a fused conv or Conv2dRaw)
//   out = bf16(v)                       (round to nearest even)
//   out = act ? epilogue::silu(out) : out
//
// held bit for bit to models/cuda_epilogue.py:epilogue_plain.  Every
// float op is an explicit _rn intrinsic (no FMA contraction).
//
// Bound on an H100: bytes, 4 read and 2 written an element (plus the
// channel vectors) at 3.35 TB/s.  Design: a grid-stride loop of 8
// elements a thread, two 16-byte loads in and one 16-byte store out, the
// channel index carried from one step to the next instead of divided.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;       // elements a thread a step (16 bytes out)

template <bool kScale, bool kAct>
__device__ __forceinline__ __nv_bfloat16 one(float y, const float* scale,
                                             const float* shift, int ch) {
  if (kScale) y = __fmul_rn(y, __ldg(scale + ch));
  __nv_bfloat16 out = __float2bfloat16_rn(__fadd_rn(y, __ldg(shift + ch)));
  return kAct ? epilogue::silu(out) : out;
}

template <bool kScale, bool kAct>
__global__ void __launch_bounds__(kThreads)
epilogue_kernel(const float* __restrict__ y, const float* __restrict__ scale,
                const float* __restrict__ shift,
                __nv_bfloat16* __restrict__ out, long long n, int c,
                bool vec) {
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long threads = (long long)gridDim.x * kThreads;
  if (!vec) {                 // unaligned pointers: element by element
    int ch = (int)(tid % c);
    const int step = (int)(threads % c);
    for (long long i = tid; i < n; i += threads) {
      out[i] = one<kScale, kAct>(y[i], scale, shift, ch);
      ch += step;
      if (ch >= c) ch -= c;
    }
    return;
  }
  const long long nvec = n / kVec;
  int ch = (int)((tid * kVec) % c);
  const int step = (int)((threads * kVec) % c);
  for (long long v = tid; v < nvec; v += threads) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(y) + 2 * v);
    const float4 b = __ldg(reinterpret_cast<const float4*>(y) + 2 * v + 1);
    const float in[kVec] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    __align__(16) __nv_bfloat16 o[kVec];
    int cc = ch;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      o[j] = one<kScale, kAct>(in[j], scale, shift, cc);
      if (++cc == c) cc = 0;
    }
    reinterpret_cast<uint4*>(out)[v] = *reinterpret_cast<const uint4*>(o);
    ch += step;
    if (ch >= c) ch -= c;
  }
  // the last n % 8 elements
  const long long i = nvec * kVec + tid;
  if (i < n) out[i] = one<kScale, kAct>(y[i], scale, shift, (int)(i % c));
}

template <bool kScale, bool kAct>
int launch(const float* y, const float* scale, const float* shift,
           __nv_bfloat16* out, long long n, int c, cudaStream_t stream) {
  const bool vec = ((reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long work = vec ? n / kVec + kVec : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  epilogue_kernel<kScale, kAct><<<(unsigned)blocks, kThreads, 0, stream>>>(
      y, scale, shift, out, n, c, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y f32 [B, H, W, C] contiguous (channels_last [B, C, H, W]), n = its
// element count; scale (may be null) and shift f32 [C]; out bf16 with y's
// layout.
int cy_conv_epilogue(const void* y, const void* scale, const void* shift,
                     void* out, long long n, int c, int act,
                     cudaStream_t stream) {
  if (n < 0 || c < 1 || shift == nullptr) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const float* yf = static_cast<const float*>(y);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  if (scale != nullptr)
    return act ? launch<true, true>(yf, sc, sh, o, n, c, stream)
               : launch<true, false>(yf, sc, sh, o, n, c, stream);
  return act ? launch<false, true>(yf, sc, sh, o, n, c, stream)
             : launch<false, false>(yf, sc, sh, o, n, c, stream);
}

}  // extern "C"
