// What the flash-attention sources share (flash_attention.cu,
// flash_attention_sm90.cu, flash_attention_bwd.cu and
// flash_attention_bwd_sm90.cu): the reference's masking and flooring
// constants, P's split into two bf16 parts, and the mma.sync tile product
// with its transposed shared-memory fragment load.
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

// c += a b for one m16n8k16 tile: a the 16 x 16 row-major A fragment, (b0,
// b1) the 16 x 8 column-major B fragment, c the 16 x 8 float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed; lane l gives the
// address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

}  // namespace flash
