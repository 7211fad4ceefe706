// Greedy-NMS keep mask, one thread block per image.
//
// Replaces caesar_yolo_tpu/detect/pallas_nms.py:nms_suppress
// (_suppress_kernel), which iterates the greedy fixpoint
//   alive_i = valid_i & !any_{j<i}(alive_j & iou(j, i) > thr)
// over a VMEM-resident [K, K] IoU matrix.
//
// Design.  Phase 1: the block's threads fill a kill bitmask
// mask[j][w] (bit l set when row j, if alive, kills i = 32*w + l:
// j < i, both valid, iou > thr).  Phase 2: one warp walks the rows in
// score order; a row that no earlier kept row removed is kept and ORs
// its mask row into the removed set.  That sequential greedy scan gives
// the fixpoint's mask (caesar_yolo_tpu/detect/nms.py:20-26).
// The mask is K*ceil(K/32)*4 bytes: 32 KB at K=512, kept in shared
// memory; at K=2048 (512 KB) it exceeds the 227 KB a block may use, so
// the wrapper passes a global scratch buffer instead.
//
// Exactness: the mask must equal the XLA sweep bit for bit, so the IoU
// keeps the op order of utils/boxes.iou_matrix with explicitly rounded
// intrinsics (no FMA contraction; the file is also built with
// -fmad=false) and an IEEE division.
//
// Bound on an H100: about 8 KB in and K bytes out per image, and K^2/2
// IoU pairs (~1.3 MFLOP at K=512): the sequential K-step scan makes it
// latency-bound, not bandwidth- or FLOP-bound.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemMaskLimit = 160 * 1024;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// a: the higher-ranked box j, b: the candidate victim i.
__device__ __forceinline__ bool kills(float4 a, float area_a, float4 b,
                                      float area_b, float thr) {
  float iw = __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x));
  float ih = __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y));
  float inter = __fmul_rn(fmaxf(iw, 0.0f), fmaxf(ih, 0.0f));
  float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
  return iou > thr;
}

__host__ __device__ size_t base_smem_bytes(int k) {
  int words = (k + 31) / 32;
  return (size_t)k * sizeof(float4) + (size_t)k * sizeof(float) +
         (size_t)words * sizeof(uint32_t) + (size_t)((k + 15) / 16) * 16;
}

size_t mask_bytes(int k) {
  return (size_t)k * ((k + 31) / 32) * sizeof(uint32_t);
}

bool mask_in_smem(int k) {
  return base_smem_bytes(k) + mask_bytes(k) <= (size_t)kSmemMaskLimit;
}

__global__ void nms_suppress_kernel(const float* __restrict__ boxes_t,
                                    const uint8_t* __restrict__ valid,
                                    uint8_t* __restrict__ alive,
                                    uint32_t* __restrict__ scratch, int k,
                                    float thr, int smem_mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) / 32;
  const int img = blockIdx.x;
  float4* bx = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(bx + k);
  uint32_t* removed = reinterpret_cast<uint32_t*>(area + k);
  uint8_t* vld = reinterpret_cast<uint8_t*>(removed + words);
  uint32_t* mask =
      smem_mask ? reinterpret_cast<uint32_t*>(smem + base_smem_bytes(k))
                : scratch + (size_t)img * k * words;

  const float* src = boxes_t + (size_t)img * 4 * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    float4 b = make_float4(src[i], src[k + i], src[2 * k + i], src[3 * k + i]);
    bx[i] = b;
    area[i] = box_area(b);
    vld[i] = valid[(size_t)img * k + i];
  }
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0u;
  __syncthreads();

  for (int t = threadIdx.x; t < k * words; t += blockDim.x) {
    const int j = t / words;
    const int w = t - j * words;
    uint32_t bits = 0u;
    // only victims i > j can be killed by j; skip words wholly at or
    // below row j
    if (vld[j] && 32 * w + 31 > j) {
      const float4 a = bx[j];
      const float aa = area[j];
      for (int l = 0; l < 32; ++l) {
        const int i = 32 * w + l;
        if (i > j && i < k && vld[i] && kills(a, aa, bx[i], area[i], thr))
          bits |= 1u << l;
      }
    }
    mask[t] = bits;
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int i = 0; i < k; ++i) {
      const int wi = i >> 5;
      const bool keep = vld[i] && !((removed[wi] >> (i & 31)) & 1u);
      if (lane == 0) alive[(size_t)img * k + i] = keep ? 1 : 0;
      if (keep) {
        const uint32_t* row = mask + (size_t)i * words;
        for (int w = wi + lane; w < words; w += 32) removed[w] |= row[w];
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" {

// Number of uint32 scratch words the caller must pass for B images of K
// candidates (0 when the mask fits in shared memory).
long long cy_nms_scratch_words(int b, int k) {
  if (mask_in_smem(k)) return 0;
  return (long long)b * k * ((k + 31) / 32);
}

// boxes_t [B, 4, K] f32 (x1, y1, x2, y2 rows, score-descending along K,
// class offsets applied), valid [B, K] u8 -> alive [B, K] u8.
int cy_nms_suppress(const float* boxes_t, const uint8_t* valid, uint8_t* alive,
                    uint32_t* scratch, int b, int k, float thr,
                    cudaStream_t stream) {
  if (b == 0 || k == 0) return (int)cudaSuccess;
  const int smem_mask = mask_in_smem(k) ? 1 : 0;
  size_t smem = base_smem_bytes(k) + (smem_mask ? mask_bytes(k) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      nms_suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_suppress_kernel<<<b, kThreads, smem, stream>>>(boxes_t, valid, alive,
                                                      scratch, k, thr,
                                                      smem_mask);
  return (int)cudaGetLastError();
}

}  // extern "C"
