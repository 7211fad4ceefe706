// Per-row fractional shift: the shear pass of the augmentation resampler.
//
// Replaces caesar_yolo_tpu/ops/pallas_shift.py:fractional_row_shift_batch
// (_shift_kernel), which pads each row by `pad` pixels and rolls it twice
// in VMEM lanes.
//
//   out[b, y, x, c] = img[b, y, x + k, c] * (1 - f) + img[b, y, x + k + 1, c] * f
//
// with k = clip(floor(shift[b, y]), -pad, pad - 1) and f = shift - floor(shift)
// given per row by the wrapper, and `pad_val` wherever x + k or x + k + 1 falls
// outside [0, W) (the padded canvas of the TPU kernel, without materialising
// it).
//
// Design: one thread per output element; neighbouring threads read
// neighbouring elements of the same row, so both reads are coalesced.  Built
// with -fmad=false: the lerp rounds after each product and after the sum, as
// the plain version's three tensor ops do, so the outputs are bit-equal.
//
// Bound on an H100: bytes.  At the 640 px training canvas [16,1092,1092,3]
// f32 a pass reads and writes 228.9 MB each: 0.137 ms at 3.35 TB/s.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void row_shift_kernel(const float* __restrict__ img,
                                 const int* __restrict__ k0,
                                 const float* __restrict__ frac,
                                 float* __restrict__ out, int w, int c,
                                 float pad_val, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int cc = (int)(i % c);
  const long long pix = i / c;
  const int x = (int)(pix % w);
  const long long row = pix / w;
  const int k = k0[row];
  const float f = frac[row];
  const float* src = img + row * w * c;
  const int x0 = x + k;
  const int x1 = x0 + 1;
  const float a0 = (x0 >= 0 && x0 < w) ? src[(long long)x0 * c + cc] : pad_val;
  const float a1 = (x1 >= 0 && x1 < w) ? src[(long long)x1 * c + cc] : pad_val;
  const float t0 = a0 * (1.0f - f);
  const float t1 = a1 * f;
  out[i] = t0 + t1;
}

}  // namespace

extern "C" {

// img, out [B, H, W, C] f32 contiguous; k0 [B, H] int32; frac [B, H] f32.
int cy_row_shift(const float* img, const int* k0, const float* frac,
                 float* out, int b, int h, int w, int c, float pad_val,
                 cudaStream_t stream) {
  const long long total = (long long)b * h * w * c;
  if (total == 0) return (int)cudaSuccess;
  const long long blocks = (total + kThreads - 1) / kThreads;
  row_shift_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      img, k0, frac, out, w, c, pad_val, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
