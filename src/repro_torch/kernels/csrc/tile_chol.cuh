// The Cholesky of a diagonal block of at most 32 columns, by one warp or a
// few, that frontal_factor.cu (the diagonal step of every panel) and
// tile_kernels.cu (each 32-column panel of chol_tile) share, and the
// inverse of its factor formed beside it (inv_cols, chol_tile's; the batched
// factor inverts with tile::invert_tile, tile_invert.cuh). With the inverse
// the rows below the block become a product, L21 = A21 L11^-T, with no
// per-row chain, as the TPU kernel forms them
// (repro/kernels/frontal_cholesky.py `_chol_block` :66, `_tri_inv_block`
// :84, the dot_general at :216).
#pragma once

namespace tile {

// The warps of a diagonal step: W warps hold an NB-wide block, each the
// CPW = NB / W columns from CPW w of every row (lane = row).
template <int NB, int W>
struct Cols {
  static constexpr int CPW = NB / W;
  static_assert(NB % (4 * W) == 0, "whole 16-byte pieces a warp");
};

// Warp w's columns of row `lane` of the lower m x m block T (row stride
// ld) into r: entries on or below the diagonal of rows below m, identity
// rows from m to NB. Entries above the diagonal are never read.
template <int NB, int W>
__device__ __forceinline__ void load_cols(const float* T, int ld, int m,
                                          int lane, int warp,
                                          float (&r)[Cols<NB, W>::CPW]) {
  const int k0 = warp * Cols<NB, W>::CPW;
#pragma unroll
  for (int t = 0; t < Cols<NB, W>::CPW; ++t) {
    const int k = k0 + t;
    r[t] = lane < m ? (k <= lane ? T[lane * ld + k] : 0.f)
                    : (k == lane ? 1.f : 0.f);
  }
}

// Warp w's columns of row `lane` (< nb) into T (zeros above the diagonal).
template <int NB, int W>
__device__ __forceinline__ void store_cols(float* T, int ld, int nb, int lane,
                                           int warp,
                                           const float (&r)[Cols<NB, W>::CPW]) {
  const int k0 = warp * Cols<NB, W>::CPW;
  if (lane < nb) {
#pragma unroll
    for (int t = 0; t < Cols<NB, W>::CPW; ++t) T[lane * ld + k0 + t] = r[t];
  }
}

// The W warps of a diagonal step wait for each other: the warp itself, or
// the named barrier `bar` (not 0, which __syncthreads uses) of 32 W threads.
template <int W>
__device__ __forceinline__ void sync_warps(int bar) {
  if constexpr (W == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(32 * W) : "memory");
}

// W warps factor the leading nb columns of the block (nb <= NB <= 32) held
// as load_cols put it, in place: on return each warp's r holds its columns
// of row `lane` of L in the first nb columns and the Schur complement
// after them (the whole factor when the block is nb x nb), with zeros
// above the diagonal. Right-looking: at step j the owner of column j
// writes it to one half of `col` (2 x 32 floats, 16-byte aligned, the
// halves alternating so that step j + 1's write never meets a step-j
// read), the warps wait for each other, and every lane reads the pivot,
// its own entry and the column below j in 16-byte broadcasts. The update
// uses the unscaled column, a_ik -= (a_ij / a_jj) a_kj, so a step's
// dependent chain is one shared-memory round trip, a fast division and an
// FMA; the scaling L[i, j] = a_ij / sqrt(a_jj) comes after the chain,
// through rsqrtf. Both are approximate to 2 ulp: an IEEE division or square
// root on the chain brings a slow-path branch that keeps the compiler from
// overlapping the steps. Why shared memory and several warps, not shuffles
// within one: a warp's shuffles of one step are independent, but the
// compiler keeps two or so in flight, so a 32-wide factor in one warp waits
// out most of its ~500 shuffle latencies one after another; with the
// columns split over four warps, the warps' loads overlap. Step j's multiplier
// is zero in rows at or above j and every row updates all of its columns
// past j, so entries above the diagonal collect sums that no step reads (a
// row's multiplier at step k > lane is zero, and the columns read are
// entries below the diagonal); they are zeroed at the end. A non-positive
// pivot gives NaN (rsqrtf). Identity rows (lane >= the block's rows) are
// never pivots and stay identity.
//
// WB (W or W + 1) warps meet at the barriers: W + 1 when a warp runs
// inv_cols beside the factor.
template <int NB, int W, int WB = W>
__device__ __forceinline__ void chol_cols(float (&r)[Cols<NB, W>::CPW],
                                          float* col, int nb, int lane,
                                          int warp, int bar) {
  constexpr int CPW = Cols<NB, W>::CPW;
  const int k0 = warp * CPW;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j < nb) {
      float* const cj = col + 32 * (j & 1);
      if (warp == j / CPW) cj[lane] = r[j % CPW];
      sync_warps<WB>(bar);
      const float c = lane > j ? __fdividef(cj[lane], cj[j]) : 0.f;
#pragma unroll
      for (int q = 0; q < CPW / 4; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(cj + k0 + 4 * q);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = 4 * q + u;
          r[t] = fmaf(k0 + t > j ? -c : 0.f, av[u], r[t]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < CPW; ++t) {
    const int k = k0 + t;
    const float p = __shfl_sync(0xffffffffu, r[t], k), rs = rsqrtf(p);
    r[t] = lane < k ? 0.f : k >= nb ? r[t] : lane == k ? p * rs : r[t] * rs;
  }
}

// One warp beside the W warps of chol_cols<NB, W, W + 1>, at the same
// barriers, forms the inverse of the factor from the columns they publish,
// so the inverse costs no time after the factor. Each column j published
// is column j of A~, the unscaled factor (A~[i, j] = a_ij at step j, its
// diagonal the pivots p_j), and L = A~ P^-1/2 with P = diag(p), so L^-1 =
// P^1/2 A~^-1. Lane c forms column c of A~^-1 by column-oriented forward
// substitution: at step j, y_j /= p_j, then y_i -= A~[i, j] y_j below j.
// On return y[i] = (A~^-1)[i, lane]; the caller scales row i by sqrt(p_i)
// (L's diagonal) once the factor is stored.
template <int NB, int WB>
__device__ __forceinline__ void inv_cols(float (&y)[NB], const float* col,
                                         int nb, int lane, int bar) {
#pragma unroll
  for (int i = 0; i < NB; ++i) y[i] = i == lane ? 1.f : 0.f;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j < nb) {
      const float* const cj = col + 32 * (j & 1);
      sync_warps<WB>(bar);
      y[j] = __fdividef(y[j], cj[j]);
#pragma unroll
      for (int q = (j + 1) / 4; q < NB / 4; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(cj + 4 * q);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * q + u > j) y[4 * q + u] = fmaf(-av[u], y[j], y[4 * q + u]);
      }
    }
  }
}

}  // namespace tile
