// Division by a divisor used many times, rounded as __fdiv_rn, shared by
// the kernels that must equal their plain versions bit for bit (preproc.cu,
// clahe.cu).
#pragma once

#include <cuda_runtime.h>

namespace divide {

// a / d.b rounded to nearest, as __fdiv_rn, with d.r = __frcp_rn(d.b) made
// once a plane: two remainder corrections (r within half an ulp of 1/b and
// the first corrected quotient within an ulp of a/b, the second rounds
// correctly: Markstein's theorem), taken where a, b and so every
// intermediate keep far from overflow and underflow; elsewhere (NaN, inf,
// tiny or huge operands) the IEEE division.  The compiler's division
// checks and branches on every call, which serialises a float4's four.  A
// zero numerator gives +0 (IEEE: -0 for -0; in K3 -0 numerators occur
// only at masked pixels, in K7 a bin of +-0 is bin 0).
struct Divisor {
  float b, r;
  bool fast;
};
__device__ __forceinline__ Divisor make_divisor(float b) {
  return {b, __frcp_rn(b), b >= 0x1p-60f && b <= 0x1p60f};
}
__device__ __forceinline__ float div_rn(float a, Divisor d) {
  const float m = fabsf(a);
  if (d.fast && (a == 0.0f || (m >= 0x1p-60f && m <= 0x1p60f))) {
    float q = __fmul_rn(a, d.r);
    q = __fmaf_rn(__fmaf_rn(-q, d.b, a), d.r, q);
    return __fmaf_rn(__fmaf_rn(-q, d.b, a), d.r, q);
  }
  return __fdiv_rn(a, d.b);
}

}  // namespace divide
