// The reference's SiLU on the card, shared by the conv epilogue (K10,
// epilogue.cu) and the int8 conv's epilogue (K9, qconv.cu), so that both
// equal their plain versions (models/cuda_epilogue.py:silu) bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace epilogue {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bf16: y * (1 / (1 + exp(-y))) with each of the four ops rounded to bf16,
// as JAX's `x * jax.nn.sigmoid(x)` on a bf16 value and as PyTorch's bf16
// ops evaluate it: exp in f32 by expf (not __expf, whose error PyTorch's
// torch.exp does not share), the sum, the reciprocal (1 / u rounded to
// nearest, which __frcp_rn is) and the product each rounded.
__device__ __forceinline__ __nv_bfloat16 silu(__nv_bfloat16 y) {
  const float v = __bfloat162float(y);
  const float e = bf16_round(expf(-v));
  const float u = bf16_round(__fadd_rn(1.0f, e));
  const float r = bf16_round(__frcp_rn(u));
  return __float2bfloat16_rn(__fmul_rn(v, r));
}

// f32: F.silu's form, y / (1 + exp(-y)), the port's f32 SiLU (it agrees
// with the reference's form to f32 rounding).
__device__ __forceinline__ float silu(float y) {
  return __fdiv_rn(y, __fadd_rn(1.0f, expf(-y)));
}

}  // namespace epilogue
