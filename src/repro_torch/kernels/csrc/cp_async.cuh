// cp.async (sm_80+) copies from device memory into shared memory with zero
// fill, shared by tile_kernels.cu and frontal_factor.cu.
#pragma once

namespace cpa {

// A 16- or 4-byte copy of which the first `bytes` come from `src` and the
// rest are zero (`bytes` = 0 reads nothing and zero-fills the destination).
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 4 floats from src[0..left) (left may be <= 0 or past 4) into dst,
// zero-filling the rest: one 16-byte copy when WIDE (src 16-byte aligned),
// else four 4-byte ones. `any` is a valid address read with size 0.
template <bool WIDE>
__device__ __forceinline__ void copy_chunk(float* dst, const float* src,
                                           int left, const float* any) {
  if (WIDE) {
    copy16(dst, left > 0 ? src : any, left >= 4 ? 16 : left > 0 ? 4 * left : 0);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      copy4(dst + u, left > u ? src + u : any, left > u ? 4 : 0);
  }
}

}  // namespace cpa
