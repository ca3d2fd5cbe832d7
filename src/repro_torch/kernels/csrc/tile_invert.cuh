// The diagonal-tile inverse that tri_solve.cu (ahead of its sweep's chain)
// and tile_kernels.cu (the diagonal blocks of tri_inv_tile) share.
#pragma once

namespace tile {

// One warp inverts the diagonal tile T staged row-major in C
// (row stride cs), in place. Lane c solves T y = e_c left-looking in
// registers: y_i = (e_c[i] - T[i, :i] y[:i]) / T[i, i], with row i of T read
// as broadcast 16-byte loads, four partial sums, and 1 / T[i, i] made by
// lane i ahead of the chain and shuffled in. It then writes its column of
// Inv = T^-1: transposed for LOWER (C[i * cs + j] = Inv[j, i], where the
// lower sweep's xp step reads it), row-major otherwise (C[i * cs + j] =
// Inv[i, j], zeros above the diagonal). Entries above T's diagonal are
// never read into the sums. BS = 32 fixes the width at compile time (every
// panel of a front wider than 32); BS = 0 takes it from `bs`. C and cs must
// keep T's rows 16-byte aligned.
template <bool LOWER, int BS>
__device__ void invert_tile(float* C, int cs, int bs_arg, int lane) {
  const int bs = BS ? BS : bs_arg;
  const float rd = lane < bs ? 1.f / C[lane * cs + lane] : 0.f;
  float v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float ri = __shfl_sync(0xffffffffu, rd, i);
    v[i] = 0.f;
    if (i < bs) {
      const float* row = C + i * cs;
      float s[4] = {i == lane ? 1.f : 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; 4 * q < i; ++q) {
        const float4 t = *reinterpret_cast<const float4*>(row + 4 * q);
        const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * q + u < i) s[u] = fmaf(-tv[u], v[4 * q + u], s[u]);
      }
      v[i] = ((s[0] + s[1]) + (s[2] + s[3])) * ri;
    }
  }
  __syncwarp();
  if (lane < bs) {
    if (LOWER) {
      float4* out = reinterpret_cast<float4*>(C + lane * cs);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (4 * q < bs)
          out[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                               v[4 * q + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (i < bs) C[i * cs + lane] = v[i];
    }
  }
  __syncwarp();
}

}  // namespace tile
