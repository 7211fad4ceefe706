// Greedy-NMS keep mask (kernel K1): a kill mask built across the card,
// then a register scan, one warp per image.
//
// Replaces caesar_yolo_tpu/detect/pallas_nms.py:nms_suppress
// (_suppress_kernel), which iterates the greedy fixpoint
//   alive_i = valid_i & !any_{j<i}(alive_j & iou(j, i) > thr)
// over a VMEM-resident [K, K] IoU matrix.
//
// Design.  Launch 1 (nms_mask_kernel) fills the kill bitmask
// mask[b][j][w] (bit l set when row j, if alive, kills i = 32*w + l:
// j < i, both valid, iou > thr) into a device buffer of B*K*ceil(K/32)
// words (1 MB at [32, 512], which stays in L2): a grid over (stripe of
// rows, image), the rows of a block interleaved with the other blocks'
// so that the work is even, one (row, word) a thread, the image's boxes
// and areas in shared memory, laid out so that the lanes of a warp read
// neighbouring words' boxes without bank conflicts.  Words wholly below
// a row's own word are never read and not written.
// Launch 2 (nms_scan_kernel), one block an image: its warps copy the
// image's mask rows into shared memory (all of them at K = 512: 32 KB),
// then one warp walks the rows 32 at a time from there: lane l holds row
// 32c+l's diagonal word c; the warp resolves the block's 32 greedy
// decisions on the removed word broadcast from its owner lane (a chain
// of register operations on shuffled words), writes the 32 keep flags,
// then ORs the kept rows' later words across the warp (one __reduce_or
// a word) into the removed words, each lane owning words lane, lane +
// 32, ...  No step waits on device memory.
// That sequential greedy scan gives the fixpoint's mask
// (caesar_yolo_tpu/detect/nms.py:20-26).
//
// Exactness: the mask must equal the XLA sweep bit for bit, so the IoU
// keeps the op order of utils/boxes.iou_matrix with explicitly rounded
// intrinsics (no FMA contraction; the file is also built with
// -fmad=false) and an IEEE division; iou > thr is compared as such.
//
// Bound on an H100: about 8 KB in and K bytes out per image, and K^2/2
// IoU pairs (~1.3 MFLOP at K=512); the scan's K/32 dependent block steps
// make it latency-bound, not bandwidth- or FLOP-bound.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaskThreads = 512;   // (row, word) pairs a block
constexpr int kScanThreads = 256;   // copy the rows; warp 0 scans
constexpr int kMaxK = 8192;
constexpr int kMaxSlots = kMaxK / 32 / 32;   // removed words a lane owns

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
  // 0 / uni is 0 for uni > 0: the division is skipped for disjoint boxes
  float iou = (uni > 0.0f && inter != 0.0f) ? __fdiv_rn(inter, uni) : 0.0f;
  return iou > thr;
}

// Block (b, image) of nb a image: rows b, b + nb, b + 2 nb, ... (rows of
// them), so that every block gets early rows with many words and late
// rows with few; each thread one (row, word) pair.  Shared memory holds
// all columns: column 32 u + l at position l * words + u.
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float* __restrict__ boxes_t,
                const uint8_t* __restrict__ valid, uint32_t* __restrict__ mask,
                int k, int words, int rows, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int img = blockIdx.y;
  float4* bx = reinterpret_cast<float4*>(smem);
  float* area = reinterpret_cast<float*>(bx + 32 * words);
  uint8_t* vld = reinterpret_cast<uint8_t*>(area + 32 * words);

  const float* src = boxes_t + (size_t)img * 4 * k;
  const uint8_t* vsrc = valid + (size_t)img * k;
  for (int p = threadIdx.x; p < 32 * words; p += blockDim.x) {
    const int l = p / words, u = p - l * words;
    const int i = 32 * u + l;
    float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    uint8_t v = 0;
    if (i < k) {
      b = make_float4(__ldg(src + i), __ldg(src + k + i), __ldg(src + 2 * k + i),
                      __ldg(src + 3 * k + i));
      v = __ldg(vsrc + i);
    }
    bx[p] = b;
    area[p] = box_area(b);
    vld[p] = v;
  }
  __syncthreads();

  const int t = threadIdx.x / words;
  const int j = blockIdx.x + gridDim.x * t;
  const int w = threadIdx.x - t * words;
  if (t >= rows || j >= k || w < (j >> 5)) return;
  const int pj = (j & 31) * words + (j >> 5);
  uint32_t bits = 0u;
  if (vld[pj]) {
    const float4 a = bx[pj];
    const float aa = area[pj];
    for (int l = 0; l < 32; ++l) {
      const int p = l * words + w;
      if (32 * w + l > j && vld[p] && kills(a, aa, bx[p], area[p], thr))
        bits |= 1u << l;
    }
  }
  mask[((size_t)img * k + j) * words + w] = bits;
}

// One block an image.  All its warps copy the image's mask rows into
// shared memory, a chunk of rows at a time (the whole mask at K = 512),
// with its valid flags; then warp 0 scans the chunk, 32 rows a step, from
// shared memory alone.  Each lane of warp 0 owns kSlots removed words:
// lane, lane + 32, ...
template <int kSlots>
__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const uint8_t* __restrict__ valid,
                const uint32_t* __restrict__ mask, uint8_t* __restrict__ alive,
                int k, int words, int chunk) {
  extern __shared__ __align__(16) uint32_t rows[];   // [chunk][words | 1]
  uint8_t* vld = reinterpret_cast<uint8_t*>(rows + (size_t)chunk * (words | 1));
  const int img = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const uint32_t* m = mask + (size_t)img * k * words;
  const uint8_t* vsrc = valid + (size_t)img * k;
  for (int i = threadIdx.x; i < k; i += kScanThreads) vld[i] = __ldg(vsrc + i);
  uint32_t removed[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) removed[s] = 0u;

  const int ws = words | 1;   // odd row stride: no bank conflicts
  const int warp = threadIdx.x >> 5;
  for (int row0 = 0; row0 < k; row0 += chunk) {
    const int n = min(chunk, k - row0);
    __syncthreads();   // the previous chunk is scanned
    const uint32_t* src = m + (size_t)row0 * words;
    if ((words & 3) == 0) {   // 16-byte loads, four rows' worth in flight
      const int q4 = words >> 2;
#pragma unroll 4
      for (int i = threadIdx.x; i < n * q4; i += kScanThreads) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src) + i);
        const int r = i / q4, w = 4 * (i - r * q4);
        uint32_t* dst = rows + r * ws + w;
        dst[0] = v.x;
        dst[1] = v.y;
        dst[2] = v.z;
        dst[3] = v.w;
      }
    } else {
#pragma unroll 4
      for (int r = warp; r < n; r += kScanThreads / 32)
        for (int w = lane; w < words; w += 32)
          rows[r * ws + w] = __ldg(src + (size_t)r * words + w);
    }
    __syncthreads();
    if (threadIdx.x >= 32) continue;
    for (int c = row0 >> 5; c < (row0 + n + 31) >> 5; ++c) {
      const int r = 32 * c + lane;
      const uint32_t* row = rows + (size_t)(r - row0) * ws;
      const uint32_t vb = __ballot_sync(kFull, r < k && vld[r]);
      const uint32_t d = r < k ? row[c] : 0u;
      // the removed word of block c, from the lane that owns it
      uint32_t own = removed[0];
#pragma unroll
      for (int s = 1; s < kSlots; ++s)
        if (s == (c >> 5)) own = removed[s];
      uint32_t rw = __shfl_sync(kFull, own, c & 31);
      // row i of the block is kept when valid and not removed by a kept
      // row before it; its diagonal word then removes later rows of the
      // block
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const uint32_t di = __shfl_sync(kFull, d, i);
        if ((vb & ~rw) & (1u << i)) rw |= di;
      }
      const uint32_t keep = vb & ~rw;
      const bool kept = (keep >> lane) & 1u;
      if (r < k) alive[(size_t)img * k + r] = kept;
      // each later word: the OR of the kept rows' words, to its owner lane
#pragma unroll 4
      for (int w = c + 1; w < words; ++w) {
        const uint32_t v = __reduce_or_sync(kFull, kept ? row[w] : 0u);
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
          if (w == lane + 32 * s) removed[s] |= v;
      }
    }
  }
}

template <int kSlots>
cudaError_t launch_scan(const uint8_t* valid, const uint32_t* mask,
                        uint8_t* alive, int b, int k, int words,
                        cudaStream_t stream) {
  // rows a chunk: all of them if they fit, else whole 32-row blocks
  const int kMaxSmem = 200 * 1024;
  const int ws = words | 1;
  int chunk = (kMaxSmem - k) / (ws * (int)sizeof(uint32_t));
  chunk = chunk >= k ? k : chunk / 32 * 32;
  const size_t smem = (size_t)chunk * ws * sizeof(uint32_t) + k;
  cudaError_t err = cudaFuncSetAttribute(
      nms_scan_kernel<kSlots>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  nms_scan_kernel<kSlots><<<b, kScanThreads, smem, stream>>>(
      valid, mask, alive, k, words, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// boxes_t [B, 4, K] f32 (x1, y1, x2, y2 rows, score-descending along K,
// class offsets applied), valid [B, K] u8 -> alive [B, K] u8, through
// mask, a caller-allocated [B, K, ceil(K/32)] u32 buffer.  Two launches.
int cy_nms_suppress(const float* boxes_t, const uint8_t* valid, uint8_t* alive,
                    uint32_t* mask, int b, int k, float thr,
                    cudaStream_t stream) {
  if (b == 0 || k == 0) return (int)cudaSuccess;
  if (k > kMaxK || b > 65535) return (int)cudaErrorInvalidValue;
  const int words = (k + 31) / 32;
  int rows = kMaskThreads / words;
  rows = rows < 1 ? 1 : (rows > 32 ? 32 : rows);
  const size_t smem = (size_t)32 * words * (sizeof(float4) + sizeof(float) + 1);
  cudaError_t err = cudaFuncSetAttribute(
      nms_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_mask_kernel<<<dim3((k + rows - 1) / rows, b), rows * words, smem,
                    stream>>>(boxes_t, valid, mask, k, words, rows, thr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int slots = (words + 31) / 32;
  if (slots == 1) return (int)launch_scan<1>(valid, mask, alive, b, k, words, stream);
  if (slots == 2) return (int)launch_scan<2>(valid, mask, alive, b, k, words, stream);
  if (slots <= 4) return (int)launch_scan<4>(valid, mask, alive, b, k, words, stream);
  return (int)launch_scan<kMaxSlots>(valid, mask, alive, b, k, words, stream);
}

}  // extern "C"
