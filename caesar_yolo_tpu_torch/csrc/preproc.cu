// Fused zscale stretch + masked min/max + min-max normalisation.
//
// Replaces caesar_yolo_tpu/ops/pallas_preproc.py:fused_zscale_minmax
// (_fused_kernel), which holds one 640x640 tile in VMEM and runs the
// README-default chain (zscale, then min-max) in one pass.  The per-tile
// zscale limits (vmin, vmax) come from the sampled line fit outside the
// kernel, as in the reference.
//
// Design: after a tiny launch that sets zlim[P, 2] to (+inf, -inf), two
// launches over planes [P, HW].  The reduce launch spreads
// each plane over many blocks; each block reduces the masked min/max of
// the stretched values and merges it into zlim[P, 2] with integer
// atomics (exact: min/max are order-free, and every valid stretched
// value lies in (0, 1], where the float order equals the int order of
// the bit patterns).  The apply launch recomputes the stretch and writes
// the normalised value.  Built with -fmad=false and explicitly rounded
// intrinsics so that every value equals the plain PyTorch chain.
//
// Bound on an H100: one 640x640 f32 plane is 1.6 MB in and 1.6 MB out
// (3.3 MB, ~1 us at 3.35 TB/s); a handful of flops a pixel, so bytes
// bound it.  This version reads the input twice.
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerPlane = 32;

// jnp.clip and the masking convention of caesar_yolo_tpu/ops/transforms.py:
// NaN propagates through the clip (comparisons are false), masked input
// pixels (exactly 0 or non-finite) give 0.
__device__ __forceinline__ float zscale_apply(float x, float vmin, float vmax) {
  const float span = __fsub_rn(vmax, vmin);
  float z = span != 0.0f ? __fdiv_rn(__fsub_rn(x, vmin), span)
                         : __fsub_rn(x, vmin);
  z = z < 0.0f ? 0.0f : z;
  z = z > 1.0f ? 1.0f : z;
  const bool valid_in = x != 0.0f && isfinite(x);
  return valid_in ? z : 0.0f;
}

__global__ void zlims_init_kernel(float* __restrict__ zlims, int planes) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < planes) {
    zlims[2 * p] = INFINITY;
    zlims[2 * p + 1] = -INFINITY;
  }
}

__global__ void reduce_kernel(const float* __restrict__ x,
                              const float* __restrict__ vlims,
                              int* __restrict__ zlims, long long hw) {
  const int p = blockIdx.y;
  const float vmin = vlims[2 * p], vmax = vlims[2 * p + 1];
  const float* xp = x + (size_t)p * hw;
  float lo = INFINITY, hi = -INFINITY;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < hw;
       i += (long long)gridDim.x * blockDim.x) {
    const float z = zscale_apply(xp[i], vmin, vmax);
    if (z != 0.0f && isfinite(z)) {
      lo = fminf(lo, z);
      hi = fmaxf(hi, z);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  __shared__ float slo[kThreads / 32], shi[kThreads / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    slo[warp] = lo;
    shi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      lo = fminf(lo, slo[w]);
      hi = fmaxf(hi, shi[w]);
    }
    if (lo <= hi) {  // the block saw at least one valid value
      atomicMin(zlims + 2 * p, __float_as_int(lo));
      atomicMax(zlims + 2 * p + 1, __float_as_int(hi));
    }
  }
}

__global__ void apply_kernel(const float* __restrict__ x,
                             const float* __restrict__ vlims,
                             const float* __restrict__ zlims,
                             float* __restrict__ out, long long hw,
                             float norm_min, float norm_max) {
  const int p = blockIdx.y;
  const float vmin = vlims[2 * p], vmax = vlims[2 * p + 1];
  const float zmin = zlims[2 * p], zmax = zlims[2 * p + 1];
  const float zspan = __fsub_rn(zmax, zmin);
  const float denom = zspan != 0.0f ? zspan : 1.0f;
  const float nspan = __fsub_rn(norm_max, norm_min);
  const float* xp = x + (size_t)p * hw;
  float* op = out + (size_t)p * hw;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < hw;
       i += (long long)gridDim.x * blockDim.x) {
    const float z = zscale_apply(xp[i], vmin, vmax);
    const bool valid = z != 0.0f && isfinite(z);
    const float o = __fadd_rn(
        __fmul_rn(__fdiv_rn(__fsub_rn(z, zmin), denom), nspan), norm_min);
    op[i] = valid ? o : 0.0f;
  }
}

}  // namespace

extern "C" {

// x [P, HW] f32 planes, vlims [P, 2] f32 zscale limits; zlims [P, 2] f32
// receives the masked (min, max) of the stretched planes ((+inf, -inf)
// where no pixel is valid); out [P, HW] f32.
int cy_zscale_minmax(const float* x, const float* vlims, float* zlims,
                     float* out, int planes, long long hw, float norm_min,
                     float norm_max, cudaStream_t stream) {
  if (planes == 0 || hw == 0) return (int)cudaSuccess;
  zlims_init_kernel<<<(planes + kThreads - 1) / kThreads, kThreads, 0,
                      stream>>>(zlims, planes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(kBlocksPerPlane, planes);
  reduce_kernel<<<grid, kThreads, 0, stream>>>(
      x, vlims, reinterpret_cast<int*>(zlims), hw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  apply_kernel<<<grid, kThreads, 0, stream>>>(x, vlims, zlims, out, hw,
                                              norm_min, norm_max);
  return (int)cudaGetLastError();
}

}  // extern "C"
