// Per-row fractional shift: the shear passes of the augmentation resampler
// (kernel K8).
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
// it).  Built with -fmad=false and explicitly rounded intrinsics: the lerp
// rounds after each product and after the sum, as the plain version's
// tensor ops do, so the outputs are bit-equal.
//
// Two routes, chosen from the input's strides by ops/cuda_shift.py:route.
//  - Row route: the shifted axis is contiguous (the x-shear on the canvas
//    [B, H, W, C]).  A block walks a run of rows.  Each row, W*C floats,
//    is staged whole into shared memory by one bulk copy (cp.async.bulk,
//    counted on an mbarrier) where its address and length are 16-byte
//    multiples, else by 4-byte cp.async; the next row is copied while the
//    current one is computed (two buffers).  In row coordinates the taps
//    of output j are j + k*C and j + (k+1)*C, out of frame exactly when
//    outside [0, W*C): 32-bit index math, k and f read once a row, no
//    division.  Each thread writes whole float4s.
//  - Column route: the shifted axis is the memory rows of a canvas
//    [B, N, R, C], given as its transposed view [B, R, N, C] (the y-shear,
//    which reads the canvas in place instead of copying its transpose).
//    A block takes a strip of X columns (X*C contiguous floats) and a band
//    of Y output rows.  It stages the source rows the band reads, Y + 1 +
//    kmax - kmin of them over the strip's shifts (at most Y + X + 1 for
//    the augmentation's shears, |tan r| <= 1), into shared memory by
//    cp.async, then writes the band coalesced along the strip.  A band
//    whose source rows do not fit (shifts far apart within a strip) reads
//    them from device memory instead, with the same arithmetic.
//
// Bound on an H100: bytes.  At the 640 px training canvas [16,1092,1092,3]
// f32 a pass reads and writes 228.9 MB each: 0.137 ms at 3.35 TB/s.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

using namespace acopy;

constexpr int kRowThreads = 256;
constexpr int kRowBlocksPerSm = 8;

__device__ __forceinline__ float lerp_rn(float a0, float a1, float f,
                                         float g) {
  return __fadd_rn(__fmul_rn(a0, g), __fmul_rn(a1, f));
}

// rows [B*H] of `len` = W*C floats; kVec: rows at 16-byte aligned
// addresses, len % 4 == 0 (bulk copies in, float4s out)
template <bool kVec>
__global__ void __launch_bounds__(kRowThreads)
row_shift_kernel(const float* __restrict__ img, const int* __restrict__ k0,
                 const float* __restrict__ frac, float* __restrict__ out,
                 int rows, int len, int c, float pad_val) {
  extern __shared__ __align__(16) float buf[];  // two rows
  __shared__ __align__(8) uint64_t bar[2];
  const int tid = threadIdx.x;
  const int stride = (len + 3) & ~3;
  if (kVec && tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init_fence();
  }
  __syncthreads();
  auto stage = [&](int r, int s) {
    const float* src = img + (size_t)r * len;
    float* dst = buf + s * stride;
    if (kVec) {
      if (tid == 0) {
        fence_proxy_async();
        mbar_arrive_expect(&bar[s], (uint32_t)len * 4u);
        bulk_copy(dst, src, (uint32_t)len * 4u, &bar[s]);
      }
    } else {
      for (int i = tid; i < len; i += kRowThreads) cp_async4(dst + i, src + i);
      cp_async_commit();
    }
  };
  int r = blockIdx.x;
  if (r < rows) stage(r, 0);
  for (int it = 0; r < rows; r += gridDim.x, ++it) {
    const int s = it & 1;
    const int next = r + gridDim.x;
    // buffer s ^ 1 was released by the barrier that closed the last row
    if (next < rows) stage(next, s ^ 1);
    if (kVec) {
      mbar_wait(&bar[s], (it >> 1) & 1);
    } else {
      if (next < rows)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
    }
    const float* row = buf + s * stride;
    float* o = out + (size_t)r * len;
    const int k = k0[r] * c;
    const float f = frac[r];
    const float g = __fsub_rn(1.0f, f);
    if (kVec) {
      for (int j = 4 * tid; j < len; j += 4 * kRowThreads) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int a = j + e + k, b = a + c;
          const float a0 = (unsigned)a < (unsigned)len ? row[a] : pad_val;
          const float a1 = (unsigned)b < (unsigned)len ? row[b] : pad_val;
          v[e] = lerp_rn(a0, a1, f, g);
        }
        *reinterpret_cast<float4*>(o + j) = make_float4(v[0], v[1], v[2], v[3]);
      }
    } else {
      for (int j = tid; j < len; j += kRowThreads) {
        const int a = j + k, b = a + c;
        const float a0 = (unsigned)a < (unsigned)len ? row[a] : pad_val;
        const float a1 = (unsigned)b < (unsigned)len ? row[b] : pad_val;
        o[j] = lerp_rn(a0, a1, f, g);
      }
    }
    __syncthreads();  // every read of buffer s is done before it is refilled
  }
}

// canvas [B, N, R, C] in memory, shifted along N with one shift per
// (b, column): grid (strips of X columns, bands of Y rows, B); `cap` staged
// rows of `wpad` floats in shared memory
__global__ void col_shift_kernel(const float* __restrict__ img,
                                 const int* __restrict__ k0,
                                 const float* __restrict__ frac,
                                 float* __restrict__ out, int n, int r, int c,
                                 int xw, int yh, int cap, int wpad,
                                 float pad_val) {
  extern __shared__ __align__(16) float rows_s[];
  __shared__ int kr[2];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int b = blockIdx.z, x0 = blockIdx.x * xw, y0 = blockIdx.y * yh;
  const int xs = min(xw, r - x0), ys = min(yh, n - y0);
  const int w = xs * c;  // floats of a row in this strip
  const int* kb = k0 + (size_t)b * r + x0;
  if (tid == 0) {
    kr[0] = INT_MAX;
    kr[1] = INT_MIN;
  }
  __syncthreads();
  if (tid < xs) {
    atomicMin(&kr[0], kb[tid]);
    atomicMax(&kr[1], kb[tid]);
  }
  __syncthreads();
  // source rows [lo, hi] hold every in-frame tap of the band
  const int lo = max(0, y0 + kr[0]);
  const int hi = min(n - 1, y0 + ys + kr[1]);
  const int nrows = hi - lo + 1;
  const bool staged = nrows <= cap;
  const size_t pitch = (size_t)r * c;
  const float* src = img + (size_t)b * n * pitch + (size_t)x0 * c;
  float* dst = out + (size_t)b * n * pitch + (size_t)x0 * c;
  if (staged && nrows > 0) {
    const bool vec = (w & 3) == 0 && (pitch & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(src) & 15) == 0;
    const int unit = vec ? 4 : 1;
    const int per_row = w / unit;
    const int q = tid % per_row, step = nthreads / per_row;
    if (tid < step * per_row) {
      for (int rr = tid / per_row; rr < nrows; rr += step) {
        const float* s = src + (size_t)(lo + rr) * pitch + q * unit;
        float* d = rows_s + rr * wpad + q * unit;
        if (vec)
          cp_async16(d, s);
        else
          cp_async4(d, s);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  // thread -> (element e of the strip's rows, first output row)
  const int xc = xw * c;
  const int e = tid % xc, step = nthreads / xc;
  if (e >= w || tid >= step * xc) return;
  const int x = e / c;
  const int k = kb[x];
  const float f = frac[(size_t)b * r + x0 + x];
  const float g = __fsub_rn(1.0f, f);
  for (int yy = tid / xc; yy < ys; yy += step) {
    const int y = y0 + yy;
    const int sa = y + k, sb = sa + 1;
    float a0 = pad_val, a1 = pad_val;
    if (staged) {
      if ((unsigned)sa < (unsigned)n) a0 = rows_s[(sa - lo) * wpad + e];
      if ((unsigned)sb < (unsigned)n) a1 = rows_s[(sb - lo) * wpad + e];
    } else {
      if ((unsigned)sa < (unsigned)n) a0 = src[(size_t)sa * pitch + e];
      if ((unsigned)sb < (unsigned)n) a1 = src[(size_t)sb * pitch + e];
    }
    dst[(size_t)y * pitch + e] = lerp_rn(a0, a1, f, g);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

}  // namespace

extern "C" {

// Row route.  img, out: rows [B*H] of len = W*C contiguous floats; k0
// [B*H] int32; frac [B*H] f32.  Two rows of shared memory must fit in a
// block's 227 KB (ops/cuda_shift.py refuses rows of more than 28672
// floats).
int cy_row_shift(const float* img, const int* k0, const float* frac,
                 float* out, int rows, int len, int c, float pad_val,
                 cudaStream_t stream) {
  if (rows == 0 || len == 0) return (int)cudaSuccess;
  const bool vec = (len & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(img) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const size_t smem = 2 * (size_t)((len + 3) & ~3) * sizeof(float);
  auto kernel = vec ? row_shift_kernel<true> : row_shift_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = rows < sm_count() * kRowBlocksPerSm
                         ? rows
                         : sm_count() * kRowBlocksPerSm;
  kernel<<<blocks, kRowThreads, smem, stream>>>(img, k0, frac, out, rows, len,
                                                c, pad_val);
  return (int)cudaGetLastError();
}

// Column route.  img, out: canvases [B, N, R, C] contiguous, shifted along
// N; k0, frac [B, R].  Strips of xw columns, bands of yh rows, blocks of
// `threads` threads (a multiple of xw * C).
int cy_col_shift(const float* img, const int* k0, const float* frac,
                 float* out, int b, int n, int r, int c, int xw, int yh,
                 int threads, float pad_val, cudaStream_t stream) {
  if (b == 0 || n == 0 || r == 0 || c == 0) return (int)cudaSuccess;
  if (xw < 1 || yh < 1 || threads % (xw * c) != 0 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  const int cap = yh + xw + 2;
  const int wpad = (xw * c + 3) & ~3;
  const size_t smem = (size_t)cap * wpad * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      col_shift_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((r + xw - 1) / xw, (n + yh - 1) / yh, b);
  col_shift_kernel<<<grid, threads, smem, stream>>>(
      img, k0, frac, out, n, r, c, xw, yh, cap, wpad, pad_val);
  return (int)cudaGetLastError();
}

}  // extern "C"
