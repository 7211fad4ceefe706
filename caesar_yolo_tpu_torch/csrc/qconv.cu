// int8 convolution of the PTQ path (kernel K9): one pass quantizes the
// input into a padded int8 copy, then an implicit GEMM on Hopper's
// tensor cores (TMA into a ring of shared-memory stages, wgmma s8) with
// the dequantize, bias and SiLU fused into its epilogue.
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
//   out = act ? epilogue::silu(y) : y                (the reference's SiLU
//                                                     in bf16, F.silu's
//                                                     form in f32)
//
// held bit for bit to models/cuda_qconv.py:qconv_plain.  Every float op is
// an explicit _rn intrinsic, so FMA contraction cannot fold the
// dequantize; the division of the quantize goes through divide::div_rn
// (IEEE-rounded, without the compiler's per-call branches).
//
// Design (Hopper):
//  - quantize_kernel reads x once, through its strides (NCHW,
//    channels_last and channel slices all occur), and writes xq int8
//    [B, H, W, Cp] contiguous, Cp = cin rounded up to 16, the padded
//    channels 0.  The weights arrive laid out once as [cout][k][k][Cp]
//    (cuda_qconv.pack_weights).
//  - qgemm_kernel: M = output pixels, N = cout, K = k*k*Cp walked tap by
//    tap, each tap in groups of `kb` channels (32, 64 or 128; those past Cp
//    come as TMA's out-of-bounds zeros).  A block owns a tw x th rectangle
//    of one image's output pixels (tw*th <= 128 rows of the M tile,
//    chosen by cuda_qconv.plan) and BN (64 or 128) output channels.  One
//    producer warp issues two TMA loads a stage: a [th*st, tw*st, kb] box
//    of xq at the tap's offset, traversed with the conv's stride (image
//    edges and padding are out-of-bounds zeros), and a [BN, kb] box of the
//    weights, each landing as rows of kb bytes in the swizzle of that
//    width (wgmma's K-major layout), in a ring of 3 or 4 stages guarded
//    by mbarriers.  Two consumer warpgroups (64 rows
//    each) issue wgmma.mma_async m64nBNk32 s8 with s32 accumulators in
//    registers, kb / 32 of them a stage, one stage's products left in
//    flight while the next stage's wait.  (Rows of 16 bytes, one box a
//    16-channel chunk and no swizzle, measured twice as slow: the count of
//    TMA requests bound them, not the bytes.)
//  - The epilogue dequantizes each accumulator, rounds, applies SiLU,
//    stages the tile in shared memory and stores channels_last rows in
//    16-byte vectors.
//
// Bound on an H100: operations at the large 3x3 layers (2*M*N*K int8 ops
// against 1979 TOPS), bytes at the 1x1 ones.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "divide.cuh"
#include "epilogue.cuh"

namespace {

constexpr int kBM = 128;                 // rows of the M tile (two warpgroups)
constexpr int kChunk = 16;               // bytes (channels) a chunk
constexpr int kMaxKb = 128;              // K bytes a stage (one swizzle row)
constexpr int kStep = 32;                // K bytes a wgmma
constexpr int kConsumers = 256;          // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kQuantThreads = 256;

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

struct QShape {
  long long sn, sc, sh, sw;  // input strides (elements)
  long long pixels;          // B * H * W
  int h, w, cin, cp;
};

// one thread a (pixel, 16-channel chunk): 16 quantized bytes stored at once
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const T* __restrict__ x, const float* __restrict__ xs_ptr,
                int8_t* __restrict__ xq, QShape p) {
  const divide::Divisor dv = divide::make_divisor(*xs_ptr);
  const int c16 = p.cp / kChunk;
  const long long total = p.pixels * c16;
  const long long hw = (long long)p.h * p.w;
  for (long long i = (long long)blockIdx.x * kQuantThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kQuantThreads) {
    const long long pix = i / c16;
    const int c0 = (int)(i - pix * c16) * kChunk;
    const long long img = pix / hw;
    const int rem = (int)(pix - img * hw);
    const int iy = rem / p.w, ix = rem - (rem / p.w) * p.w;
    const T* src = x + img * p.sn + iy * p.sh + ix * p.sw + c0 * p.sc;
    float v[kChunk];
    if (p.sc == 1 && c0 + kChunk <= p.cin &&
        (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      constexpr int per = 16 / sizeof(T);   // values a 16-byte load
#pragma unroll
      for (int j = 0; j < kChunk; j += per) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(src + j));
        const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int l = 0; l < per; ++l) v[j + l] = to_f32(t[l]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j)
        v[j] = c0 + j < p.cin ? to_f32(src[j * p.sc]) : 0.0f;
    }
    uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (c0 + j < p.cin) words[j >> 2] |= quantize(v[j], dv) << (8 * (j & 3));
    *reinterpret_cast<uint4*>(xq + pix * p.cp + c0) =
        make_uint4(words[0], words[1], words[2], words[3]);
  }
}

// -- the GEMM: barriers, TMA, wgmma --------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// wait for the phase of `parity` to complete; a pipeline that stalls for
// about ten seconds traps (the launch fails) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(c2), "r"(smem_addr(bar)) : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile whose rows hold kb
// bytes (32, 64 or 128) in the swizzle of that width, as TMA wrote it:
// 8-row groups kb * 8 bytes apart (the stride byte offset), the leading
// byte offset unused (1), the layout 3, 2 or 1.  A K step of 32 bytes
// moves the start address by 32 within the swizzled rows.
__device__ __forceinline__ uint64_t make_desc(const void* p, int kb) {
  const uint64_t layout = kb == 128 ? 1 : kb == 64 ? 2 : 3;
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * kb) >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// D[64 x N] += A[64 x 32] * B[N x 32]^T, s8 x s8 -> s32, operands from
// shared memory (descriptors), D in registers: the accumulator layout of
// mma.m16n8 per warp (16 rows) repeated over N / 8
__device__ __forceinline__ void wgmma_n64(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(int* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}


struct GShape {
  int b, h, w, cp, cout, k, stride, pad, ho, wo;
  int tw, th, kb, groups, tiles_x, tiles_y, act;
};

// The ring: kStages stages of an A tile [kBM][kb] and a B tile [BN][kb]
// (kb up to kMaxKb), after a 1024-byte block of barriers; the epilogue's
// staging tile [kBM][BN] of T reuses the ring's memory.
template <int BN> struct Ring {
  static constexpr int kStages = BN == 128 ? 3 : 4;
  static constexpr int kStageA = kBM * kMaxKb;
  static constexpr int kStageB = BN * kMaxKb;
  static constexpr int kBytes = 2048 + kStages * (kStageA + kStageB);
};

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
qgemm_kernel(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b,
             const float* __restrict__ ws, const float* __restrict__ xs_ptr,
             const float* __restrict__ bias, T* __restrict__ y, GShape p) {
  using R = Ring<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + R::kStages;
  uint8_t* smem = base + 1024;        // the ring, later the staging tile
  uint8_t* sa = smem;
  uint8_t* sb = sa + R::kStages * R::kStageA;

  int t = blockIdx.x;
  const int tx = t % p.tiles_x;
  t /= p.tiles_x;
  const int ty = t % p.tiles_y;
  const int img = t / p.tiles_y;
  const int ox0 = tx * p.tw, oy0 = ty * p.th, n0 = blockIdx.y * BN;
  const int rows = p.tw * p.th;
  const int iters = p.k * p.k * p.groups;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == kConsumers / 32) {
    // the producer: one thread keeps the ring full
    if (lane == 0) {
      const uint32_t bytes = (rows + BN) * p.kb;
      for (int it = 0; it < iters; ++it) {
        const int s = it % R::kStages;
        if (it >= R::kStages) mbar_wait(empty + s, ((it / R::kStages) - 1) & 1);
        mbar_expect_tx(full + s, bytes);
        const int tap = it / p.groups, g = it - tap * p.groups;
        const int r = tap / p.k, q = tap - r * p.k;
        tma_load_4d(sa + s * R::kStageA, &map_a, g * p.kb,
                    ox0 * p.stride - p.pad + q, oy0 * p.stride - p.pad + r,
                    img, full + s);
        tma_load_3d(sb + s * R::kStageB, &map_b, g * p.kb, tap, n0, full + s);
      }
    }
    return;
  }

  // the consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63
  const int wg = warp >> 2;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int it = 0; it < iters; ++it) {
    const int s = it % R::kStages;
    mbar_wait(full + s, (it / R::kStages) & 1);
    const uint8_t* a = sa + s * R::kStageA + wg * 64 * p.kb;
    const uint8_t* b = sb + s * R::kStageB;
    wgmma_fence();
    for (int ks = 0; ks < p.kb; ks += kStep) {
      const uint64_t da = make_desc(a + ks, p.kb);
      const uint64_t db = make_desc(b + ks, p.kb);
      if constexpr (BN == 128) wgmma_n128(acc, da, db);
      else wgmma_n64(acc, da, db);
    }
    wgmma_commit();
    // keep this stage's products in flight; the previous stage's are done
    // and its buffers go back to the producer
    wgmma_wait_one();
    if (it > 0 && (threadIdx.x & 127) == 0)
      mbar_arrive(empty + (it - 1) % R::kStages);
  }
  wgmma_wait_all();

  // epilogue: every stage has been consumed by both warpgroups once they
  // meet here, so the ring's memory holds the output tile [128][BN] of T
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  constexpr int kRowBytes = BN * (int)sizeof(T) + 16;
  const float xs = *xs_ptr;
  const int wrow = 64 * wg + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int row = wrow + 8 * ((i & 3) >> 1);
    const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
    const int n = n0 + col;
    if (row >= rows || n >= p.cout) continue;
    const float scale = __fmul_rn(__ldg(ws + n), xs);
    const float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[i]), scale),
                              __ldg(bias + n));
    T out = from_f32<T>(v);
    if (p.act) out = epilogue::silu(out);
    *reinterpret_cast<T*>(smem + row * kRowBytes + col * sizeof(T)) = out;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

  const int ncols = min(BN, p.cout - n0);
  const bool vec = (p.cout * sizeof(T)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const int per_row = vec ? ncols * (int)sizeof(T) / 16 : ncols;
  for (int i = threadIdx.x; i < rows * per_row; i += kConsumers) {
    const int row = i / per_row, v = i - row * per_row;
    const int oy = oy0 + row / p.tw, ox = ox0 + row % p.tw;
    if (oy >= p.ho || ox >= p.wo) continue;
    T* dst = y + (((long long)img * p.ho + oy) * p.wo + ox) * p.cout + n0;
    const uint8_t* src = smem + row * kRowBytes;
    if (vec)
      reinterpret_cast<uint4*>(dst)[v] =
          reinterpret_cast<const uint4*>(src)[v];
    else
      dst[v] = reinterpret_cast<const T*>(src)[v];
  }
}

// -- host: tensor maps through the driver's entry point (no libcuda link) ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// int8 bytes in rows of kb bytes swizzled at that width, out-of-bounds
// elements zero
int encode(CUtensorMap* map, const void* base, int rank,
           const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box, const cuuint32_t* elem_strides, int kb) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank,
                          const_cast<void*>(base), dims, strides, box,
                          elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          kb == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                          : kb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : CU_TENSOR_MAP_SWIZZLE_32B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, int BN>
int launch_gemm(const void* xq, const void* wp, const void* ws,
                const void* xs, const void* bias, void* y, const GShape& p,
                cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  const cuuint64_t dims_a[4] = {(cuuint64_t)p.cp, (cuuint64_t)p.w,
                                (cuuint64_t)p.h, (cuuint64_t)p.b};
  const cuuint64_t strides_a[3] = {(cuuint64_t)p.cp,
                                   (cuuint64_t)p.cp * p.w,
                                   (cuuint64_t)p.cp * p.w * p.h};
  const cuuint32_t box_a[4] = {(cuuint32_t)p.kb, (cuuint32_t)(p.tw * p.stride),
                               (cuuint32_t)(p.th * p.stride), 1};
  const cuuint32_t step_a[4] = {1, (cuuint32_t)p.stride,
                                (cuuint32_t)p.stride, 1};
  const cuuint64_t dims_b[3] = {(cuuint64_t)p.cp, (cuuint64_t)(p.k * p.k),
                                (cuuint64_t)p.cout};
  const cuuint64_t strides_b[2] = {(cuuint64_t)p.cp,
                                   (cuuint64_t)p.cp * p.k * p.k};
  const cuuint32_t box_b[3] = {(cuuint32_t)p.kb, 1, BN};
  const cuuint32_t step_b[3] = {1, 1, 1};
  int err = encode(&map_a, xq, 4, dims_a, strides_a, box_a, step_a, p.kb);
  if (err == 0)
    err = encode(&map_b, wp, 3, dims_b, strides_b, box_b, step_b, p.kb);
  if (err != 0) return err;
  const int bytes = Ring<BN>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      qgemm_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)(p.tiles_x * p.tiles_y * p.b),
                  (unsigned)((p.cout + BN - 1) / BN));
  qgemm_kernel<T, BN><<<grid, kThreads, bytes, stream>>>(
      map_a, map_b, static_cast<const float*>(ws),
      static_cast<const float*>(xs), static_cast<const float*>(bias),
      static_cast<T*>(y), p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, cin, H, W] read through its element strides (sn, sc, sh, sw), the
// dtype 0 = f32, 1 = bf16; xs f32 [1] on the device; xq int8 [B, H, W, cp]
// contiguous, cp a multiple of 16 >= cin, the channels from cin on 0.
int cy_qconv_quantize(const void* x, int dtype, int b, int cin, int h, int w,
                      long long sn, long long sc, long long sh, long long sw,
                      const void* xs, void* xq, int cp, cudaStream_t stream) {
  if (b < 0 || cin < 1 || h < 1 || w < 1 || cp < cin || cp % kChunk ||
      dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  QShape p;
  p.sn = sn;
  p.sc = sc;
  p.sh = sh;
  p.sw = sw;
  p.pixels = (long long)b * h * w;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cp = cp;
  const long long total = p.pixels * (cp / kChunk);
  if (total == 0) return (int)cudaSuccess;
  long long blocks = (total + kQuantThreads - 1) / kQuantThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (dtype == 0)
    quantize_kernel<float><<<(unsigned)blocks, kQuantThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(xs),
        static_cast<int8_t*>(xq), p);
  else
    quantize_kernel<__nv_bfloat16>
        <<<(unsigned)blocks, kQuantThreads, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const float*>(xs), static_cast<int8_t*>(xq), p);
  return (int)cudaGetLastError();
}

// xq int8 [B, H, W, cp] contiguous; wp int8 [cout][k][k][cp] contiguous;
// ws, bias f32 [cout]; xs f32 [1] on the device; y [B, Ho, Wo, cout]
// contiguous (channels_last), dtype 0 = f32, 1 = bf16.  k in {1, 3},
// stride in {1, 2}, pad = k / 2; the tile (tw x th output pixels, kb
// channels a stage, bn output channels) from cuda_qconv.plan.  The int32
// sums are exact while 127 * 127 * k * k * cin < 2^31 (the padded channels
// add zeros), which cuda_qconv.check_shapes holds.
int cy_qconv_gemm(const void* xq, int dtype, int b, int h, int w, int cp,
                  const void* wp, const void* ws, const void* xs,
                  const void* bias, void* y, int cout, int k, int stride,
                  int pad, int act, int tw, int th, int kb, int bn,
                  cudaStream_t stream) {
  if ((k != 1 && k != 3) || (stride != 1 && stride != 2) || pad != k / 2 ||
      b < 0 || cp < kChunk || cp % kChunk || cout < 1 || h < 1 || w < 1 ||
      dtype < 0 || dtype > 1 || tw < 1 || th < 1 || tw * th > kBM ||
      tw * stride > 256 || th * stride > 256 ||
      (kb != 32 && kb != 64 && kb != 128) || (bn != 64 && bn != 128))
    return (int)cudaErrorInvalidValue;
  GShape p;
  p.b = b;
  p.h = h;
  p.w = w;
  p.cp = cp;
  p.cout = cout;
  p.k = k;
  p.stride = stride;
  p.pad = pad;
  p.ho = (h + 2 * pad - k) / stride + 1;
  p.wo = (w + 2 * pad - k) / stride + 1;
  p.tw = tw;
  p.th = th;
  p.kb = kb;
  p.groups = (cp + kb - 1) / kb;
  p.tiles_x = (p.wo + tw - 1) / tw;
  p.tiles_y = (p.ho + th - 1) / th;
  p.act = act;
  if (b == 0) return (int)cudaSuccess;
  if (dtype == 0)
    return bn == 128 ? launch_gemm<float, 128>(xq, wp, ws, xs, bias, y, p,
                                                stream)
                     : launch_gemm<float, 64>(xq, wp, ws, xs, bias, y, p,
                                               stream);
  return bn == 128
             ? launch_gemm<__nv_bfloat16, 128>(xq, wp, ws, xs, bias, y, p,
                                               stream)
             : launch_gemm<__nv_bfloat16, 64>(xq, wp, ws, xs, bias, y, p,
                                              stream);
}

}  // extern "C"
