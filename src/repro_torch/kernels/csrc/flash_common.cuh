// What the two flash-attention sources share (flash_attention.cu and
// flash_attention_sm90.cu): the reference's masking and flooring constants
// and P's split into two bf16 parts.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>
#include <cstring>

namespace flash {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kMinL = 1e-30f;    // floor of the softmax sum

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// (x0, x1) as a bf16 pair (x0 in the low half, the lower index) and the
// bf16 pair of what that rounding left over: hi + lo keeps 16 significant
// bits, within 2^-17 of the float32 values.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

}  // namespace flash
