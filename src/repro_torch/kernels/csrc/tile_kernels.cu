// The three tile kernels of the per-front factorization (backend="pallas"):
// chol_tile, tri_inv_tile and matmul_nt.
//
// Replaces: repro/kernels/frontal_cholesky.py
//   `chol_tile`    (pallas_call at :113; body `_chol_block` :66),
//   `tri_inv_tile` (pallas_call at :133; body `_tri_inv_block` :84),
//   `matmul_nt`    (pallas_call at :177; body `_matmul_nt_kernel` :146).
//
// ops.frontal_factor (repro_torch/kernels/ops.py) calls them once per panel
// of bs = 128 columns: the Cholesky of the diagonal tile, the inverse of its
// factor, then two products, the panel L21 = W21 L11^-T and the trailing
// update S -= L21 L21^T. On grid3d(32,32,32)/nd almost every front is one
// identity-padded 128 x 128 tile, so most products are 128^3; the root's
// run to (1,152 x 128)(1,152 x 128)^T.
//
// What bounds them: chol_tile and tri_inv_tile are chains of dependent
// steps on one 128 x 128 tile (0.7 MFLOP each, 33 KB read, 64 KB written),
// so their time is the chain's latency, not bytes or flops. matmul_nt is
// fp32 FMA work on the CUDA cores (TF32 stays off, so no tensor cores):
// K = 128 gives 32 flops per byte of A and B, so its bound is operations;
// at 128^3 it is latency. What limits the FMA loops of both redesigned
// kernels on the card is shared memory: a warp's 16-byte read takes four
// of its cycles whether it is a broadcast or not, so a thread with TM x TN
// outputs spends 4 (TM + TN) cycles of reads on 4 TM TN FMAs a 4-deep k step.
//
// What the designs do about it (the tiles in shared memory):
//   * chol_tile (one block of 384 threads): the tile arrives by cp.async,
//     every copy in flight at once (as tri_inv_tile's), padded with
//     identity to a multiple of 32, and is factored in panels of 32
//     columns. A panel's dependent chain is the factor of its 32 x 32
//     diagonal block in four warps' registers (tile::chol_cols, shared with
//     frontal_factor.cu: a shared-memory round trip, a fast division and an
//     FMA a column), with a fifth warp forming the factor's inverse from
//     the same published columns at the same barriers (tile::inv_cols), so
//     the inverse adds nothing to the chain; then the product L21 =
//     A21 L11^-T over every warp and the update of the next diagonal
//     block. The rest of the rank-32 update of the lower trailing 32 x 32
//     tiles runs beside the next factor (look-ahead), on register tiles of
//     4 x 4 outputs a thread laid out so that a warp's 16-byte reads are
//     broadcasts or hit distinct banks, and each panel's finished columns
//     go out beside it too. There is no per-element index arithmetic. The
//     block is the only one of its launch, so its in-place updates of the
//     staged tile need only its own barriers.
//   * tri_inv_tile (one block of 512 threads): a blocked inverse. The tile
//     arrives by cp.async, every copy in flight at once. Its ceil(bs / 32)
//     diagonal 32 x 32 blocks, padded with identity to 1, 2 or 4 blocks, are
//     inverted at once, a warp each, in registers (tile::invert_tile, shared
//     with tri_solve.cu). The off-diagonal blocks follow by recursive
//     doubling, Y21 = -Y22 (L21 Y11) at 32 -> 64 -> 128: two rounds of two
//     shared-memory products over all the warps, each skipping the zero
//     triangle of its lower-triangular operand. The dependent chain is 32
//     register steps and two product rounds where a row-by-row substitution
//     has bs steps.
//   * matmul_nt: an SGEMM on the CUDA cores. The launch picks one of four
//     output tiles (64 x 64 down to 16 x 16, 4 x 4 to 2 x 2 outputs a
//     thread) from (M, N): the one whose busiest SM makes the fewest
//     shared-memory reads, which weighs the SMs' coverage against the
//     larger tiles' fewer reads an FMA. K moves in slabs of 32 through a
//     4-stage cp.async ring (16-byte copies where the rows are 16-byte
//     aligned, 4-byte ones where not), so K = 128 is in flight at once and
//     later slabs land while this one computes; a thread with at most 16
//     outputs loads its c before the K loop. Each output is one thread's
//     sum over k in order: no atomics, the same bits every run.
#include "cp_async.cuh"
#include "kernels.h"
#include "tile_chol.cuh"
#include "tile_invert.cuh"

#include <cstdint>

namespace {

// Component u (0..3, known at compile time once unrolled) of v.
__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// ---- tri_inv_tile -----------------------------------------------------------

constexpr int kInvThreads = 512;
// Row strides (floats) of the tile and of the product scratch in shared
// memory: 16-byte rows, and neighbouring rows 16 bytes apart modulo the 128
// bytes of the banks, so the products' 16-byte reads of 4 or 8 neighbouring
// rows by a warp are free of conflicts.
constexpr int kTileLd = 132;
constexpr int kTLd = 68;

constexpr size_t inv_smem(int nb) {
  return ((size_t)32 * nb * kTileLd + (nb > 1 ? 64 * kTLd : 0)) * sizeof(float);
}

// Stages tril of the (bs, bs) tile at l (row stride ldl) into the n x n
// tile S (row stride kTileLd), padded with identity to n (a multiple of 32),
// every copy in flight at once: a warp a row, a lane 4 columns; one 16-byte
// cp.async where the 4 lie on or below the diagonal and the rows are 16-byte
// aligned, 4-byte ones that zero-fill past the diagonal where not; nothing
// above the diagonal is read. Ends with the block's barrier.
template <int NT>
__device__ __forceinline__ void stage_lower(float* S, int n,
                                            const float* __restrict__ l,
                                            int ldl, int bs, int warp,
                                            int lane) {
  const bool wide =
      ((reinterpret_cast<uintptr_t>(l) | (uintptr_t)ldl * 4) & 15) == 0;
  for (int i = warp; i < n; i += NT / 32)
    for (int k = 4 * lane; k < n; k += 128) {
      float* d = S + i * kTileLd + k;
      if (i < bs && k <= i) {
        const float* row = l + (size_t)i * ldl + k;
        if (wide && k + 3 <= i) {
          cpa::copy16(d, row, 16);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            cpa::copy4(d + u, k + u <= i ? row + u : l, k + u <= i ? 4 : 0);
        }
      } else {
        *reinterpret_cast<float4*>(d) =
            make_float4(k == i ? 1.f : 0.f, k + 1 == i ? 1.f : 0.f,
                        k + 2 == i ? 1.f : 0.f, k + 3 == i ? 1.f : 0.f);
      }
    }
  cpa::commit();
  cpa::wait<0>();
  __syncthreads();
}

// out = sign * A B for n x n blocks in shared memory (n = GI NR), summing
// k over [k_lo, k_hi) (multiples of 4) in order. The thread owns rows
// ti + GI r (r < NR) and columns 4 tj .. 4 tj + 3: it reads NR rows of A
// and one row of B a step as 16-byte loads.
template <int GI, int NR>
__device__ __forceinline__ void block_product(float* out, int ldo,
                                              const float* A, int lda,
                                              const float* B, int ldb, int ti,
                                              int tj, int k_lo, int k_hi,
                                              float sign) {
  float acc[NR][4] = {};
#pragma unroll 2
  for (int k = k_lo; k < k_hi; k += 4) {
    float4 av[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r)
      av[r] = *reinterpret_cast<const float4*>(A + (ti + GI * r) * lda + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 bv =
          *reinterpret_cast<const float4*>(B + (k + u) * ldb + 4 * tj);
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float x = comp(av[r], u);
        acc[r][0] = fmaf(x, bv.x, acc[r][0]);
        acc[r][1] = fmaf(x, bv.y, acc[r][1]);
        acc[r][2] = fmaf(x, bv.z, acc[r][2]);
        acc[r][3] = fmaf(x, bv.w, acc[r][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r)
    *reinterpret_cast<float4*>(out + (ti + GI * r) * ldo + 4 * tj) =
        make_float4(sign * acc[r][0], sign * acc[r][1], sign * acc[r][2],
                    sign * acc[r][3]);
}

// One doubling step on the 2H x 2H diagonal block at D (row stride
// kTileLd) whose halves Y11, Y22 are inverted and whose lower-left holds
// L21: T = L21 Y11 into the scratch T (k from the column: Y11 is lower),
// then Y21 = -Y22 T over L21 (k up to the row: Y22 is lower). Thread g of
// the NTG in a group (working where `on`) owns NR rows and 4 columns of
// each H x H product. The first product gives a warp one column of
// threads and the second two or four rows, so a warp's k range is nearly
// uniform.
template <int NTG, int H>
__device__ __forceinline__ void double_step(float* D, float* T, int g,
                                            bool on) {
  constexpr int GI = 4 * NTG / H, NR = H / GI;
  float* const L21 = D + H * kTileLd;
  if (on)
    block_product<GI, NR>(T, kTLd, L21, kTileLd, D, kTileLd, g % GI, g / GI,
                          4 * (g / GI), H, 1.f);
  __syncthreads();
  const int ti = g / (H / 4), tj = g % (H / 4);
  if (on)
    block_product<GI, NR>(L21, kTileLd, L21 + H, kTileLd, T, kTLd, ti, tj, 0,
                          ((ti + GI * (NR - 1)) & ~3) + 4, -1.f);
  __syncthreads();
}

// Inverse of a lower-triangular (bs, bs) tile (row stride ldl; only entries
// on or below the diagonal are read), written with zeros above the diagonal
// to the contiguous `y`. NB = 1, 2 or 4 diagonal blocks of 32 after padding
// with identity: [L 0; 0 I]^-1 = [L^-1 0; 0 I], so the pad changes nothing
// in the bs x bs corner. The tile S is inverted in place: warp w inverts
// diagonal block w; then per doubling level, for each pair of neighbouring
// w x w diagonal blocks, T = L21 Y11 into the scratch, and Y21 = -Y22 T
// over L21.
template <int NB>
__global__ void __launch_bounds__(kInvThreads)
tri_inv_tile_kernel(const float* __restrict__ l, int ldl,
                    float* __restrict__ y, int bs) {
  constexpr int n = 32 * NB, NT = kInvThreads;
  extern __shared__ float4 inv_smem4[];
  float* const S = reinterpret_cast<float*>(inv_smem4);  // n x kTileLd
  float* const T = S + n * kTileLd;                        // 64 x kTLd
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  stage_lower<NT>(S, n, l, ldl, bs, warp, lane);

  if (warp < NB)
    tile::invert_tile<false, 32>(S + warp * 32 * (kTileLd + 1), kTileLd, 32,
                                 lane);
  __syncthreads();
  if (NB >= 2) {  // 32 -> 64: half the threads a pair
    const int p = tid / (NT / 2);
    double_step<NT / 2, 32>(S + 64 * p * (kTileLd + 1), T + 32 * p,
                            tid % (NT / 2), p < NB / 2);
  }
  if (NB == 4)  // 64 -> 128: every thread
    double_step<NT, 64>(S, T, tid, true);

  const bool wide_out =
      ((reinterpret_cast<uintptr_t>(y) | (uintptr_t)bs * 4) & 15) == 0;
  for (int i = warp; i < bs; i += NT / 32) {
    const float* src = S + i * kTileLd;
    float* dst = y + (size_t)i * bs;
    if (wide_out)
      for (int k = 4 * lane; k < bs; k += 128)
        *reinterpret_cast<float4*>(dst + k) =
            *reinterpret_cast<const float4*>(src + k);
    else
      for (int k = lane; k < bs; k += 32) dst[k] = src[k];
  }
}

// ---- chol_tile --------------------------------------------------------------

constexpr int kCholThreads = 384;
constexpr int kXLd = kMaxPanel + 4;  // the panel inverse's row stride

constexpr size_t chol_smem(int n) {
  return ((size_t)n * kTileLd + 32 * kXLd + 64) * sizeof(float);
}

// L21 = A21 X for the n2 x 32 panel at P (row stride kTileLd; n2 a multiple
// of 32), X = L11^-T (row stride kXLd), in place. Group g = tid / 128 takes
// rows 32 g .. 32 g + 31: its thread (ty, tx) rows ty and ty + 16, columns
// 4 tx .. 4 tx + 3, so a warp reads 4 rows of A (broadcasts) and 8
// neighbouring 16-byte pieces of a row of X. The sums stay in registers
// until every thread has read A.
__device__ __forceinline__ void panel_product(float* P, const float* X,
                                              int n2, int tid) {
  const int g = tid / 128, ty = tid % 128 / 8, tx = tid % 8;
  const bool on = g < n2 / 32;
  float* const A = P + (32 * g + ty) * kTileLd;
  float acc[2][4] = {};
  if (on) {
#pragma unroll
    for (int k = 0; k < 32; k += 4) {
      const float4 a0 = *reinterpret_cast<const float4*>(A + k);
      const float4 a1 = *reinterpret_cast<const float4*>(A + 16 * kTileLd + k);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 x =
            *reinterpret_cast<const float4*>(X + (k + u) * kXLd + 4 * tx);
        const float v0 = comp(a0, u), v1 = comp(a1, u);
        acc[0][0] = fmaf(v0, x.x, acc[0][0]);
        acc[0][1] = fmaf(v0, x.y, acc[0][1]);
        acc[0][2] = fmaf(v0, x.z, acc[0][2]);
        acc[0][3] = fmaf(v0, x.w, acc[0][3]);
        acc[1][0] = fmaf(v1, x.x, acc[1][0]);
        acc[1][1] = fmaf(v1, x.y, acc[1][1]);
        acc[1][2] = fmaf(v1, x.z, acc[1][2]);
        acc[1][3] = fmaf(v1, x.w, acc[1][3]);
      }
    }
  }
  __syncthreads();
  if (on) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float4*>(A + 16 * i * kTileLd + 4 * tx) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// S -= L21 L21^T on the lower 32 x 32 tile (bi, t) of the trailing block
// at T (row stride kTileLd), L21 the panel at P, by thread `tid` of 64.
// Thread (ty, tx) owns rows ty + 8 i and columns tx + 8 j (i, j < 4), so a
// warp's 16-byte reads are broadcasts over 4 rows of A and 8 neighbouring
// rows of B (distinct banks). Reads the panel's columns, writes only the
// tile's.
__device__ __forceinline__ void update_tile(float* T, const float* P, int bi,
                                            int t, int tid) {
  const int ty = tid % 64 / 8, tx = tid % 8;
  const float* A = P + (32 * bi + ty) * kTileLd;
  const float* B = P + (32 * t + tx) * kTileLd;
  float acc[4][4] = {};
#pragma unroll
  for (int k = 0; k < 32; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + 8 * i * kTileLd + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(B + 8 * j * kTileLd + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
  float* const O = T + (32 * bi + ty) * kTileLd + 32 * t + tx;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) O[8 * i * kTileLd + 8 * j] -= acc[i][j];
}

// update_tile on the lower 32 x 32 tiles of the n2 x n2 trailing block
// from the t0-th on (row by row), by the ng / 64 groups of 64 threads
// (thread g of ng, ng a multiple of 64; threads at or past ng do nothing),
// a tile a group a round.
__device__ __forceinline__ void trailing_update(float* T, const float* P,
                                                int n2, int g, int ng,
                                                int t0) {
  const int tiles = n2 / 32 * (n2 / 32 + 1) / 2;
  for (int t = t0 + g / 64; g < ng && t < tiles; t += ng / 64) {
    int tk = t, bi = 0;
    while (tk > bi) tk -= ++bi;  // the t-th lower tile is (bi, tk)
    update_tile(T, P, bi, tk, g % 64);
  }
}

// Columns [c0, c0 + 32) of the leading bs x bs of S (row stride kTileLd)
// into the contiguous y, zeros above the diagonal: thread g of ng takes 4
// columns of a row, 8 threads a row, 16-byte stores where y's rows are
// 16-byte aligned.
__device__ __forceinline__ void write_strip(float* __restrict__ y, int bs,
                                            const float* S, int c0, int g,
                                            int ng) {
  const bool wide =
      ((reinterpret_cast<uintptr_t>(y) | (uintptr_t)bs * 4) & 15) == 0;
  for (int e = g; e < bs * 8; e += ng) {
    const int i = e / 8, k = c0 + 4 * (e % 8);
    if (k >= bs) continue;
    const float4 v = *reinterpret_cast<const float4*>(S + i * kTileLd + k);
    const float o[4] = {k <= i ? v.x : 0.f, k + 1 <= i ? v.y : 0.f,
                        k + 2 <= i ? v.z : 0.f, k + 3 <= i ? v.w : 0.f};
    float* const dst = y + (size_t)i * bs + k;
    if (wide) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (k + u < bs) dst[u] = o[u];
    }
  }
}

constexpr int kInvWarp = 11;  // forms each diagonal block's inverse

// The diagonal step on the 32 x 32 block at D: warps 0-3 factor it in
// place (tile::chol_cols) while warp kInvWarp forms the inverse of the
// factor, transposed, into X (tile::inv_cols), at the same barriers; other
// warps return at once. The caller's block barrier publishes both.
__device__ __forceinline__ void diag_step(float* D, float* X, float* col,
                                          int warp, int lane) {
  if (warp < 4) {
    float r[8];
    tile::load_cols<32, 4>(D, kTileLd, 32, lane, warp, r);
    tile::chol_cols<32, 4, 5>(r, col, 32, lane, warp, 1);
    tile::store_cols<32, 4>(D, kTileLd, 32, lane, warp, r);
    tile::sync_warps<5>(1);
  } else if (warp == kInvWarp) {
    float y[32];
    tile::inv_cols<32, 5>(y, col, 32, lane, 1);
    tile::sync_warps<5>(1);  // L's diagonal, sqrt(p_i), is stored in D
    float4* const out = reinterpret_cast<float4*>(X + lane * kXLd);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = y[4 * q + u] * D[(4 * q + u) * (kTileLd + 1)];
      out[q] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Cholesky of one (bs, bs) tile (bs <= 128; only entries on or below the
// diagonal of `a`, row stride lda, are read), written with zeros above the
// diagonal to the contiguous `l`. The tile is staged padded with identity
// to n = 32 ceil(bs / 32) ([A 0; 0 I] = [L 0; 0 I][L 0; 0 I]^T, so the pad
// changes nothing in the bs x bs corner) and factored in place in panels
// of 32 columns. The diagonal step (diag_step) factors the first diagonal
// block and forms its inverse; then per panel: every thread forms L21 =
// A21 L11^-T (panel_product); warps 0-3 update the next diagonal block and,
// with warp kInvWarp, take its diagonal step (look-ahead), while warps 4-9
// update the rest of the lower trailing tiles (trailing_update) and warps
// 4-10 write the panel's 32 columns of L, final from here on, to `l`
// (write_strip). A block barrier separates the steps, and within the last
// the groups touch disjoint entries: the next diagonal block, X and the
// column buffer, or the other tiles and the finished columns.
__global__ void __launch_bounds__(kCholThreads)
chol_tile_kernel(const float* __restrict__ a, int lda, float* __restrict__ l,
                 int bs) {
  extern __shared__ float4 chol_smem4[];
  const int n = (bs + 31) & ~31;
  float* const S = reinterpret_cast<float*>(chol_smem4);  // n x kTileLd
  float* const X = S + n * kTileLd;                         // 32 x kXLd
  float* const col = X + 32 * kXLd;                         // 2 x 32
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  stage_lower<kCholThreads>(S, n, a, lda, bs, warp, lane);
  diag_step(S, X, col, warp, lane);
  __syncthreads();
  for (int p0 = 0; p0 + 32 < n; p0 += 32) {
    float* const P = S + (p0 + 32) * kTileLd + p0;  // the panel below
    float* const T = P + 32;                         // the trailing block
    const int n2 = n - p0 - 32;
    panel_product(P, X, n2, tid);
    __syncthreads();
    if (warp < 4) {
      if (tid < 64) update_tile(T, P, 0, 0, tid);  // the next block
      tile::sync_warps<4>(2);
      diag_step(T, X, col, warp, lane);
    } else if (warp == kInvWarp) {
      diag_step(T, X, col, warp, lane);
    } else {  // the rest of the update (warps 4-9); the panel's columns
      trailing_update(T, P, n2, tid - 128, 192, 1);
      write_strip(l, bs, S, p0, tid - 128, 32 * (kInvWarp - 4));
    }
    __syncthreads();
  }
  write_strip(l, bs, S, n - 32, tid, kCholThreads);
}

// ---- matmul_nt --------------------------------------------------------------

constexpr int kBK = 32;        // the K slab
constexpr int kLdk = kBK + 4;  // a slab row (floats): 16-byte rows, as kTileLd
constexpr int kStages = 4;     // slabs in flight: three ahead of the one in use

// A launch configuration: thread tile TM x TN, thread grid TY x TX (TY a
// multiple of 4, TX of 8: a warp is 4 x 8 threads of it); the block's
// output tile is TY TM x TX TN.
struct MMConfig {
  int tm, tn, ty, tx;
};
constexpr MMConfig kConfigs[] = {
    {4, 4, 16, 16}, {4, 4, 8, 16}, {4, 2, 8, 16}, {2, 2, 8, 8}};
constexpr int kNumConfigs = sizeof(kConfigs) / sizeof(kConfigs[0]);

constexpr size_t matmul_smem(const MMConfig& g) {
  return (size_t)kStages * (g.ty * g.tm + g.tx * g.tn) * kLdk * sizeof(float);
}

// Copies rows [r0, r0 + R) x columns [k0, k0 + kBK) of a K-contiguous
// operand (row stride ld, nrows rows, K columns) into a slab stage,
// zero-filling past nrows and K: a thread a 16-byte chunk, a warp four rows.
// WIDE (the operand's rows 16-byte aligned): one 16-byte copy a chunk, the
// K edge through its source size; else four 4-byte copies.
template <int R, int NT, bool WIDE>
__device__ __forceinline__ void load_slab(float* dst, const float* src,
                                          int ld, int r0, int nrows, int k0,
                                          int K, int tid) {
  constexpr int kChunks = R * (kBK / 4);
#pragma unroll
  for (int e0 = 0; e0 < kChunks; e0 += NT) {
    const int e = e0 + tid;
    if (kChunks % NT == 0 || e < kChunks) {
      const int r = e / (kBK / 4), q = e % (kBK / 4);
      const int k = k0 + 4 * q;
      const int left = r0 + r < nrows ? K - k : 0;  // floats left in the row
      const float* s = left > 0 ? src + (size_t)(r0 + r) * ld + k : src;
      cpa::copy_chunk<WIDE>(dst + r * kLdk + 4 * q, s, left, src);
    }
  }
}

// out = beta * c + alpha * a b^T for a (M, K), b (N, K), c and out (M, N),
// each with its own row stride and unit column stride. `out` may be `c`
// itself (each element is read and written by one thread), but must not
// overlap a or b. beta * c is always formed, so beta = 0 still gives 0 * c.
// A block owns a BM x BN output tile (blockIdx.x runs over the tiles, row
// tile major); thread (ty, tx) owns rows ty + TY i and columns tx + TX j,
// and a warp is 4 x 8 threads, so a 16-byte slab read is a broadcast to 8
// (A) or 4 (B) lanes over 4 or 8 neighbouring rows. A thread loads its c
// before the K loop, so the read overlaps the work.
template <int TM, int TN, int TY, int TX, bool WIDE>
__global__ void __launch_bounds__(TY * TX)
matmul_nt_kernel(const float* __restrict__ a, int lda,
                 const float* __restrict__ b, int ldb, const float* c,
                 int ldc, float* out, int ldo, int M, int N, int K,
                 float alpha, float beta, int tiles_n) {
  constexpr int NT = TY * TX, BM = TY * TM, BN = TX * TN, WX = TX / 8;
  extern __shared__ float4 mm_smem4[];
  float* const As = reinterpret_cast<float*>(mm_smem4);  // stages x BM x kLdk
  float* const Bs = As + kStages * BM * kLdk;              // stages x BN x kLdk
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = (warp / WX) * 4 + lane / 8, tx = (warp % WX) * 8 + lane % 8;
  const int tm = blockIdx.x / tiles_n;
  const int r0 = tm * BM, c0 = (blockIdx.x - tm * tiles_n) * BN;
  const int nk = (K + kBK - 1) / kBK;

  auto load = [&](int stage, int kt) {
    load_slab<BM, NT, WIDE>(As + stage * BM * kLdk, a, lda, r0, M, kt * kBK,
                            K, tid);
    load_slab<BN, NT, WIDE>(Bs + stage * BN * kLdk, b, ldb, c0, N, kt * kBK,
                            K, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cpa::commit();
  }

  float cv[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = r0 + ty + TY * i, col = c0 + tx + TX * j;
      cv[i][j] = r < M && col < N ? c[(size_t)r * ldc + col] : 0.f;
    }

  float acc[TM][TN] = {};
  int stage = 0;
  for (int kt = 0; kt < nk; ++kt) {
    cpa::wait<kStages - 2>();  // slab kt has landed (this thread's part)
    __syncthreads();  // every part has; every thread is done with slab kt - 1
    const int next = kt + kStages - 1;  // into slab kt - 1's stage
    if (next < nk) load(next % kStages, next);
    cpa::commit();
    const float* A = As + stage * BM * kLdk + ty * kLdk;
    const float* B = Bs + stage * BN * kLdk + tx * kLdk;
#pragma unroll
    for (int k = 0; k < kBK; k += 4) {
      float4 av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(A + TY * i * kLdk + k);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        bv[j] = *reinterpret_cast<const float4*>(B + TX * j * kLdk + k);
      // an outer product per k, written out: nvcc schedules the same FMAs
      // slower on the card when a loop index picks the component
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
    }
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }
  cpa::wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty + TY * i;
    if (r < M) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = c0 + tx + TX * j;
        if (col < N)
          out[(size_t)r * ldo + col] = beta * cv[i][j] + alpha * acc[i][j];
      }
    }
  }
}

// The configuration for (M, N), an index into kConfigs: the one whose
// busiest SM makes the fewest shared-memory reads, which bound the kernel
// (a warp's 16-byte read takes four cycles of the SM's shared memory,
// broadcast or not): ceil(blocks / SMs) blocks (they go round the SMs)
// of TY TX threads, each making TM + TN reads a 4-deep k step. The larger
// tile wins a tie.
int matmul_config(int M, int N) {
  static const int sms = [] {
    int d = 0, n = 132;
    cudaGetDevice(&d);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, d);
    return n;
  }();
  int best = 0;
  long long best_load = -1;
  for (int i = 0; i < kNumConfigs; ++i) {
    const long long bm = kConfigs[i].ty * kConfigs[i].tm,
                    bn = kConfigs[i].tx * kConfigs[i].tn;
    const long long blocks = ((M + bm - 1) / bm) * ((N + bn - 1) / bn);
    const long long load = (blocks + sms - 1) / sms * kConfigs[i].ty *
                           kConfigs[i].tx * (kConfigs[i].tm + kConfigs[i].tn);
    if (best_load < 0 || load < best_load) {
      best = i;
      best_load = load;
    }
  }
  return best;
}

template <int TM, int TN, int TY, int TX>
const void* mm_kernel(bool wide) {
  return wide ? reinterpret_cast<const void*>(
                    matmul_nt_kernel<TM, TN, TY, TX, true>)
              : reinterpret_cast<const void*>(
                    matmul_nt_kernel<TM, TN, TY, TX, false>);
}

const void* matmul_kernel(int cfg, bool wide) {
  switch (cfg) {
    case 0: return mm_kernel<4, 4, 16, 16>(wide);
    case 1: return mm_kernel<4, 4, 8, 16>(wide);
    case 2: return mm_kernel<4, 2, 8, 16>(wide);
    default: return mm_kernel<2, 2, 8, 8>(wide);
  }
}

const void* inv_kernel(int nb) {
  return nb == 1   ? reinterpret_cast<const void*>(tri_inv_tile_kernel<1>)
         : nb == 2 ? reinterpret_cast<const void*>(tri_inv_tile_kernel<2>)
                   : reinterpret_cast<const void*>(tri_inv_tile_kernel<4>);
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
bool set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return true;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  return cudaPeekAtLastError() == cudaSuccess;
}

void fill_info(const void* kernel, int kind, int p0, int p1, int p2,
               int threads, size_t smem, int out[8]) {
  cudaFuncAttributes attr{};
  cudaFuncGetAttributes(&attr, kernel);
  out[0] = kind;
  out[1] = p0;
  out[2] = p1;
  out[3] = p2;
  out[4] = threads;
  out[5] = attr.numRegs;
  out[6] = static_cast<int>(smem + attr.sharedSizeBytes);
  out[7] = static_cast<int>(attr.localSizeBytes);
}

}  // namespace

void launch_chol_tile(const float* a, int lda, float* l, int bs,
                      cudaStream_t stream) {
  const size_t smem = chol_smem((bs + 31) & ~31);
  if (!set_smem(reinterpret_cast<const void*>(chol_tile_kernel), smem)) return;
  chol_tile_kernel<<<1, kCholThreads, smem, stream>>>(a, lda, l, bs);
}

void launch_tri_inv_tile(const float* l, int ldl, float* y, int bs,
                         cudaStream_t stream) {
  const int nb = bs <= 32 ? 1 : bs <= 64 ? 2 : 4;
  const size_t smem = inv_smem(nb);
  if (!set_smem(inv_kernel(nb), smem)) return;
  if (nb == 1)
    tri_inv_tile_kernel<1><<<1, kInvThreads, smem, stream>>>(l, ldl, y, bs);
  else if (nb == 2)
    tri_inv_tile_kernel<2><<<1, kInvThreads, smem, stream>>>(l, ldl, y, bs);
  else
    tri_inv_tile_kernel<4><<<1, kInvThreads, smem, stream>>>(l, ldl, y, bs);
}

void launch_matmul_nt(const float* a, int lda, const float* b, int ldb,
                      const float* c, int ldc, float* out, int ldo, int M,
                      int N, int K, float alpha, float beta,
                      cudaStream_t stream) {
  const int cfg = matmul_config(M, N);
  const MMConfig& g = kConfigs[cfg];
  const int bm = g.ty * g.tm, bn = g.tx * g.tn;
  const bool wide = ((reinterpret_cast<uintptr_t>(a) |
                      reinterpret_cast<uintptr_t>(b) | (uintptr_t)lda * 4 |
                      (uintptr_t)ldb * 4) & 15) == 0;
  const size_t smem = matmul_smem(g);
  const void* kernel = matmul_kernel(cfg, wide);
  if (!set_smem(kernel, smem)) return;
  int tiles_n = (N + bn - 1) / bn;
  const unsigned blocks =
      static_cast<unsigned>((long long)((M + bm - 1) / bm) * tiles_n);
  void* args[] = {&a,   &lda, &b, &ldb, &c, &ldc,   &out,
                  &ldo, &M,   &N, &K,   &alpha, &beta, &tiles_n};
  cudaLaunchKernel(kernel, dim3(blocks), dim3(g.ty * g.tx), args, smem,
                   stream);
}

int tile_kernel_info(int i, int out[8]) {
  if (i == 0) {
    fill_info(reinterpret_cast<const void*>(chol_tile_kernel), 0, kMaxTile, 0,
              0, kCholThreads, chol_smem(kMaxTile), out);
    return 1;
  }
  if (i <= 3) {
    const int nb = 1 << (i - 1);
    fill_info(inv_kernel(nb), 1, nb, 0, 0, kInvThreads, inv_smem(nb), out);
    return 1;
  }
  const int cfg = (i - 4) / 2;
  if (cfg >= kNumConfigs) return 0;
  const bool wide = (i - 4) % 2 == 0;
  const MMConfig& g = kConfigs[cfg];
  fill_info(matmul_kernel(cfg, wide), 2, g.ty * g.tm, g.tx * g.tn, wide,
            g.ty * g.tx, matmul_smem(g), out);
  return 1;
}

void matmul_nt_plan(int M, int N, int out[4]) {
  const MMConfig& g = kConfigs[matmul_config(M, N)];
  out[0] = g.ty * g.tm;
  out[1] = g.tx * g.tn;
  out[2] = (M + out[0] - 1) / out[0];
  out[3] = (N + out[1] - 1) / out[1];
}
