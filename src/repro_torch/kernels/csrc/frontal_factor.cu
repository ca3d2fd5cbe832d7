// Batched partial Cholesky of front workspaces, in place.
//
// Replaces: repro/kernels/frontal_cholesky.py `frontal_factor_batch`
//   (pallas_call at :391; body `_frontal_batch_kernel` :196, `_chol_block`
//   :66, `_tri_inv_block` :84).
//
// Computes, for each (M, M) f32 front of the (B, M, M) stack, the blocked
// right-looking partial Cholesky of the leading `npiv` columns in panels of
// `bs` <= 32 columns (any bs: 8/16/32 under pad="pow2", 20/24/28 under
// "mult8", npiv itself below 8): L11 (lower, zeros above the diagonal inside
// each diagonal tile) and L21 in the pivot columns, the Schur complement in
// the trailing block. Only the lower triangle is read and only the lower
// triangle is authoritative; output tiles wholly above the diagonal of the
// trailing block are not updated. Identity pad pivots factor to 1.
//
// What bounds it: a front reaches M = 1,280 on a 3-D grid, 6.5 MB in f32, so
// it cannot live in one block's 227 KB of shared memory the way the TPU kernel
// kept a whole front in VMEM. Each panel re-reads and re-writes the trailing
// block (from L2 at these sizes): for bs = 32 that is 8 bytes per 64 flops,
// near the line between memory and the fp32 CUDA-core rate. The panel chain
// is sequential, so at the top of the tree (B = 1) its latency bounds it:
// the Cholesky of each diagonal tile and the launches; at the bottom
// (thousands of fronts of M = 16) it is bytes and how many lanes have work.
//
// What the design does about it: fronts of M <= 32 (most of a 3-D grid's
// buckets, the most populated among them) take one launch, small_kernel,
// a warp a front: the steps of every panel at once in registers
// (tile::chol_cols over all npiv columns), so the bucket costs one kernel
// and not three a panel. Larger fronts take three kernels a panel, each
// spread over every front and as many blocks as the work allows.
//   1. diag_kernel: factors the bs x bs diagonal tile in registers
//      (tile::chol_cols, shared with chol_tile; a warp a front, four fronts
//      a block, for bs <= 16, four warps a front at 17-32), writes L11 in
//      place, inverts it (tile::invert_tile) and writes L11^-T to a
//      (B, bs, bs) scratch. The chain is bs steps of one shared-memory round
//      trip, a fast division and an FMA, not three block barriers a column.
//   2. panel_kernel, a (row tiles, front groups) grid: L21 = W21 L11^-T as
//      a product out of shared memory (W21 staged by cp.async), so the
//      root's 1,248 rows spread over 39 blocks and a bucket of M = 16 fronts
//      packs eight fronts a block instead of leaving 248 of 256 threads idle.
//   3. schur_kernel, a (lower tiles, front groups) grid: S -= L21 L21^T on
//      register tiles, the two K = bs strips staged by cp.async (16-byte
//      copies where the rows are 16-byte aligned, 4-byte ones where not).
//      The output tile is picked from the trailing size (64, 32, 16 or 8
//      square, 4 x 4 or 2 x 2 outputs a thread), and small tiles pack up to
//      16 fronts a block, so an M = 16 front does not occupy a 64 x 64 tile.
// In-place reads and writes across blocks: small_kernel's warp owns its
// front. The three steps of a panel are separate launches on one stream,
// and within a launch no block reads what another writes. diag_kernel
// touches only its front's diagonal tile and
// scratch; a panel_kernel block reads and writes only its own rows of the
// pivot columns (plus the scratch, read only); a schur_kernel block reads the
// pivot columns (written by no block of that launch) and writes only its
// own output tile of the trailing block. Every output is one thread's sum
// in a fixed order, with no atomics: the same bits every run.
#include "cp_async.cuh"
#include "kernels.h"
#include "tile_chol.cuh"
#include "tile_invert.cuh"

#include <cstdint>

namespace {

constexpr int kLd = kMaxPanel + 4;  // shared row stride: 16-byte rows whose
                                    // starts step 4 banks, so 8 rows read
                                    // 16 bytes each without a conflict
constexpr int kDiagWarps = 4;       // warps a diag_kernel / small_kernel block
constexpr int kPanelThreads = 256;
constexpr int kPanelRows = 32;      // L21 rows a block, for fronts that tall
constexpr int kSchurThreads = 256;  // most threads a schur_kernel block
constexpr int kMaxGridY = 65535;

// ---- 1. the diagonal tile ---------------------------------------------------

// W warps factor front blockIdx.x * F + f (F = kDiagWarps / W fronts a
// block, slot f = warp / W). NB (8, 16 or 32) is the block's register
// width, the smallest at least bs: one warp a front below 32, four at 32.
template <int NB, int W>
__global__ void __launch_bounds__(32 * kDiagWarps)
diag_kernel(float* __restrict__ w, float* __restrict__ xinv, int B, int M,
            int lo, int bs) {
  constexpr int F = kDiagWarps / W;
  __shared__ __align__(16) float T[F][NB][kLd];
  __shared__ __align__(16) float col[F][64];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f = warp / W, wf = warp % W, bar = 1 + f;
  const int b = blockIdx.x * F + f;
  if (b >= B) return;  // the slot's warps leave together
  float* const D = w + (size_t)b * M * M + (size_t)lo * M + lo;
  float* const Tf = &T[f][0][0];
  for (int i = wf; i < bs; i += W)
    if (lane <= i) Tf[i * kLd + lane] = D[(size_t)i * M + lane];
  tile::sync_warps<W>(bar);
  float r[NB / W];
  tile::load_cols<NB, W>(Tf, kLd, bs, lane, wf, r);
  tile::chol_cols<NB, W>(r, col[f], bs, lane, wf, bar);
  tile::store_cols<NB, W>(Tf, kLd, bs, lane, wf, r);
  tile::sync_warps<W>(bar);
  for (int i = wf; i < bs; i += W)
    if (lane < bs) D[(size_t)i * M + lane] = Tf[i * kLd + lane];
  tile::sync_warps<W>(bar);
  if (wf == 0) {
    tile::invert_tile<true, 0>(Tf, kLd, bs, lane);  // row i: (L11^-1)^T row i
    float* const X = xinv + (size_t)b * bs * bs;
#pragma unroll 4
    for (int i = 0; i < bs; ++i)
      if (lane < bs) X[i * bs + lane] = Tf[i * kLd + lane];
  }
}

// ---- the whole of a small front ---------------------------------------------

// Fronts of M <= 32 rows in one step: warp w of a block factors front
// blockIdx.x * kDiagWarps + w, the lower triangle staged in shared memory,
// a row a lane, through tile::chol_cols over all npiv pivot columns (the
// steps of every panel at once; the trailing block ends as the Schur
// complement). Writes the lower triangle back, and zeros above the
// diagonal inside each bs x bs diagonal tile of the pivot block, as the
// panel steps leave them; nothing above is written elsewhere. NB (16 or
// 32) is the register width, at least M.
template <int NB>
__global__ void __launch_bounds__(32 * kDiagWarps)
small_kernel(float* __restrict__ w, int B, int M, int npiv, int bs) {
  __shared__ __align__(16) float T[kDiagWarps][NB][kLd];
  __shared__ __align__(16) float col[kDiagWarps][64];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * kDiagWarps + warp;
  if (b >= B) return;  // the warp's own front: no block barrier follows
  float* const F = w + (size_t)b * M * M;
  float* const Tw = &T[warp][0][0];
  for (int i = 0; i < M; ++i)
    if (lane <= i) Tw[i * kLd + lane] = F[(size_t)i * M + lane];
  __syncwarp();
  float r[NB];
  tile::load_cols<NB, 1>(Tw, kLd, M, lane, 0, r);
  tile::chol_cols<NB, 1>(r, col[warp], npiv, lane, 0, 0);
  tile::store_cols<NB, 1>(Tw, kLd, M, lane, 0, r);
  __syncwarp();
  for (int i = 0; i < M; ++i)
    if (lane <= i || (i < npiv && lane < npiv && lane / bs == i / bs))
      F[(size_t)i * M + lane] = Tw[i * kLd + lane];
}

// ---- 2. the panel below it --------------------------------------------------

// Rows [row0, row0 + rt) of the pivot columns of fronts [fg blockIdx.y, +fg):
// L21 = W21 X with X = L11^-T from the scratch. A work item is a row and 4
// columns: acc over k < bs in order of W21[row, k] X[k, 4c .. 4c + 3].
template <bool WIDE>
__global__ void __launch_bounds__(kPanelThreads)
panel_kernel(float* __restrict__ w, const float* __restrict__ xinv, int B,
             int M, int lo, int bs, int rt, int fg) {
  extern __shared__ float4 panel_smem4[];
  float* const Xs = reinterpret_cast<float*>(panel_smem4);  // fg x bs x kLd
  float* const Ws = Xs + fg * bs * kLd;                      // fg x rt x kLd
  const int tid = threadIdx.x;
  const int b0 = blockIdx.y * fg, nf = min(fg, B - b0);
  const int row0 = lo + bs + blockIdx.x * rt, nr = min(rt, M - row0);
  const int cw = (bs + 3) / 4;  // 16-byte chunks a row

  for (int e = tid; e < nf * nr * cw; e += kPanelThreads) {
    const int q = e % cw, s = e / cw, g = s / nr, i = s - g * nr;
    const float* src =
        w + (size_t)(b0 + g) * M * M + (size_t)(row0 + i) * M + lo + 4 * q;
    cpa::copy_chunk<WIDE>(Ws + (g * rt + i) * kLd + 4 * q, src, bs - 4 * q,
                          w);
  }
  cpa::commit();
  for (int e = tid; e < nf * bs * cw * 4; e += kPanelThreads) {
    const int j = e % (4 * cw), s = e / (4 * cw), g = s / bs, k = s - g * bs;
    Xs[(g * bs + k) * kLd + j] =
        j < bs ? xinv[(size_t)(b0 + g) * bs * bs + k * bs + j] : 0.f;
  }
  cpa::wait<0>();
  __syncthreads();

  for (int e = tid; e < nf * nr * cw; e += kPanelThreads) {
    const int c = e % cw, s = e / cw, g = s / nr, i = s - g * nr;
    const float* a = Ws + (g * rt + i) * kLd;
    const float* x = Xs + g * bs * kLd + 4 * c;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < bs; ++k) {
      const float ak = a[k];
      const float4 xv = *reinterpret_cast<const float4*>(x + k * kLd);
      acc[0] = fmaf(ak, xv.x, acc[0]);
      acc[1] = fmaf(ak, xv.y, acc[1]);
      acc[2] = fmaf(ak, xv.z, acc[2]);
      acc[3] = fmaf(ak, xv.w, acc[3]);
    }
    float* dst =
        w + (size_t)(b0 + g) * M * M + (size_t)(row0 + i) * M + lo + 4 * c;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (4 * c + u < bs) dst[u] = acc[u];
  }
}

// ---- 3. the trailing update -------------------------------------------------

// The output tiles: TT x TT outputs a thread, a TY x TY thread grid, so a
// BT = TT TY square tile; up to kSchurThreads / TY^2 fronts a block.
struct SchurConfig {
  int tt, ty;
};
constexpr SchurConfig kSchur[] = {{4, 16}, {2, 16}, {2, 8}, {2, 4}};
constexpr int kNumSchur = sizeof(kSchur) / sizeof(kSchur[0]);

// blockIdx.x enumerates the lower tiles (ti >= tk) of the trailing block row
// by row; thread slot g of the block takes front fpb blockIdx.y + g. Thread
// (ty, tx) of a slot owns rows ty + TY i and columns tx + TY j of the tile,
// so a warp's 16-byte strip reads are broadcasts over few rows (A) or
// neighbouring rows (B). Each thread loads its outputs before waiting on
// the strips, then writes S - acc.
template <int TT, int TY, bool WIDE>
__global__ void __launch_bounds__(kSchurThreads)
schur_kernel(float* __restrict__ w, int B, int M, int lo, int bs, int fpb) {
  constexpr int BT = TT * TY, NT = TY * TY;
  extern __shared__ float4 schur_smem4[];
  const int g = threadIdx.x / NT, lt = threadIdx.x % NT;
  float* const As = reinterpret_cast<float*>(schur_smem4) + g * 2 * BT * kLd;
  float* const Bs = As + BT * kLd;
  const int b = blockIdx.y * fpb + g;
  if (b >= B) return;  // the slot's own front: no block barrier follows
  const int s0 = lo + bs;
  const int t = blockIdx.x;
  int ti = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  while (ti * (ti + 1) / 2 > t) --ti;
  const int tk = t - ti * (ti + 1) / 2;
  const int r0 = s0 + ti * BT, c0 = s0 + tk * BT;
  float* const W = w + (size_t)b * M * M;

  const int cw = (bs + 3) / 4;
  for (int e = lt; e < 2 * BT * cw; e += NT) {
    const int q = e % cw, s = e / cw, half = s / BT, r = s - half * BT;
    const int row = (half ? c0 : r0) + r;
    cpa::copy_chunk<WIDE>((half ? Bs : As) + r * kLd + 4 * q,
                          W + (size_t)row * M + lo + 4 * q,
                          row < M ? bs - 4 * q : 0, w);
  }
  cpa::commit();

  const int ty = lt / TY, tx = lt % TY;
  float cv[TT][TT];
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int j = 0; j < TT; ++j) {
      const int r = r0 + ty + TY * i, c = c0 + tx + TY * j;
      cv[i][j] = r < M && c < M ? W[(size_t)r * M + c] : 0.f;
    }
  cpa::wait<0>();
  // the slot's threads only: the strips are the slot's own
  if constexpr (NT >= 32)
    asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(NT) : "memory");
  else
    __syncwarp(((1u << NT) - 1) << (threadIdx.x % 32 / NT * NT));

  float acc[TT][TT] = {};
  const float* A = As + ty * kLd;
  const float* Bp = Bs + tx * kLd;
  for (int k = 0; k < bs; k += 4) {
    float4 av[TT], bv[TT];
#pragma unroll
    for (int i = 0; i < TT; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + TY * i * kLd + k);
#pragma unroll
    for (int j = 0; j < TT; ++j)
      bv[j] = *reinterpret_cast<const float4*>(Bp + TY * j * kLd + k);
#pragma unroll
    for (int i = 0; i < TT; ++i)
#pragma unroll
      for (int j = 0; j < TT; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const int r = r0 + ty + TY * i;
    if (r < M) {
#pragma unroll
      for (int j = 0; j < TT; ++j) {
        const int c = c0 + tx + TY * j;
        if (c < M) W[(size_t)r * M + c] = cv[i][j] - acc[i][j];
      }
    }
  }
}

// ---- launch plans -----------------------------------------------------------

int sm_count() {
  static const int sms = [] {
    int d = 0, n = 132;
    cudaGetDevice(&d);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, d);
    return n;
  }();
  return sms;
}

int schur_fpb(const SchurConfig& c, int B) {
  return min(B, kSchurThreads / (c.ty * c.ty));
}

long long schur_tiles(const SchurConfig& c, int n) {
  const long long nt = (n + c.tt * c.ty - 1) / (c.tt * c.ty);
  return nt * (nt + 1) / 2;
}

// The output tile for a trailing block of n rows in B fronts: the largest
// that n fills (64, 32, 16, 8), then smaller while the grid has fewer blocks
// than the card has SMs and the tile is above 16.
int schur_config(int n, int B) {
  int i = n >= 64 ? 0 : n >= 32 ? 1 : n >= 16 ? 2 : 3;
  while (i < 2) {
    const int fpb = schur_fpb(kSchur[i], B);
    if (schur_tiles(kSchur[i], n) * ((B + fpb - 1) / fpb) >= sm_count()) break;
    ++i;
  }
  return i;
}

size_t schur_smem(const SchurConfig& c, int fpb) {
  return (size_t)fpb * 2 * c.tt * c.ty * kLd * sizeof(float);
}

template <int TT, int TY>
const void* schur_ptr(bool wide) {
  return wide ? reinterpret_cast<const void*>(schur_kernel<TT, TY, true>)
              : reinterpret_cast<const void*>(schur_kernel<TT, TY, false>);
}

const void* schur_kernel_ptr(int cfg, bool wide) {
  switch (cfg) {
    case 0: return schur_ptr<4, 16>(wide);
    case 1: return schur_ptr<2, 16>(wide);
    case 2: return schur_ptr<2, 8>(wide);
    default: return schur_ptr<2, 4>(wide);
  }
}

// The diagonal step's fronts a block at register width nb.
int diag_fronts(int nb) { return nb == 32 ? 1 : kDiagWarps; }

const void* diag_kernel_ptr(int nb) {
  return nb == 8    ? reinterpret_cast<const void*>(diag_kernel<8, 1>)
         : nb == 16 ? reinterpret_cast<const void*>(diag_kernel<16, 1>)
                    : reinterpret_cast<const void*>(diag_kernel<32, 4>);
}

const void* panel_kernel_ptr(bool wide) {
  return wide ? reinterpret_cast<const void*>(panel_kernel<true>)
              : reinterpret_cast<const void*>(panel_kernel<false>);
}

// Rows a panel_kernel block takes of each front and fronts a block, for
// nrows rows below the diagonal tile: kPanelRows rows of one front, or
// every row of up to 8 fronts (at most 64 rows a block).
void panel_plan(int nrows, int B, int& rt, int& fg) {
  if (nrows >= kPanelRows) {
    rt = kPanelRows;
    fg = 1;
  } else {
    rt = nrows;
    fg = min(B, max(1, min(8, 64 / nrows)));
  }
}

size_t panel_smem(int bs, int rt, int fg) {
  return (size_t)fg * (bs + rt) * kLd * sizeof(float);
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

void launch_frontal_factor(float* w, float* xinv, int B, int M, int npiv,
                           int bs, cudaStream_t stream) {
  const int nb = bs <= 8 ? 8 : bs <= 16 ? 16 : 32;
  const bool wide = ((reinterpret_cast<uintptr_t>(w) | (uintptr_t)M * 4) &
                     15) == 0;
  if (M <= 32) {
    void* args[] = {&w, &B, &M, &npiv, &bs};
    cudaLaunchKernel(M <= 16 ? reinterpret_cast<const void*>(small_kernel<16>)
                             : reinterpret_cast<const void*>(small_kernel<32>),
                     dim3((B + kDiagWarps - 1) / kDiagWarps),
                     dim3(32 * kDiagWarps), args, 0, stream);
    return;
  }
  for (int lo = 0; lo < npiv; lo += bs) {
    const bool wide_lo = wide && lo % 4 == 0;
    const int nrows = M - lo - bs;
    void* dargs[] = {&w, &xinv, &B, &M, &lo, &bs};
    cudaLaunchKernel(diag_kernel_ptr(nb),
                     dim3((B + diag_fronts(nb) - 1) / diag_fronts(nb)),
                     dim3(32 * kDiagWarps), dargs, 0, stream);
    if (cudaPeekAtLastError() != cudaSuccess) return;
    if (nrows <= 0) continue;

    // fronts go down the grid's y: at most kMaxGridY groups a launch
    int rt, fg;
    panel_plan(nrows, B, rt, fg);
    const int cfg = schur_config(nrows, B);
    const SchurConfig& c = kSchur[cfg];
    int fpb = schur_fpb(c, B);
    const void* pk = panel_kernel_ptr(wide_lo);
    const void* sk = schur_kernel_ptr(cfg, wide_lo);
    const unsigned tiles = static_cast<unsigned>(schur_tiles(c, nrows));
    for (int b0 = 0; b0 < B; b0 += kMaxGridY * fg) {
      float* wb = w + (size_t)b0 * M * M;
      float* xb = xinv + (size_t)b0 * bs * bs;
      int nbk = min(B - b0, kMaxGridY * fg);
      void* args[] = {&wb, &xb, &nbk, &M, &lo, &bs, &rt, &fg};
      cudaLaunchKernel(pk, dim3((nrows + rt - 1) / rt, (nbk + fg - 1) / fg),
                       dim3(kPanelThreads), args, panel_smem(bs, rt, fg),
                       stream);
      if (cudaPeekAtLastError() != cudaSuccess) return;
    }
    for (int b0 = 0; b0 < B; b0 += kMaxGridY * fpb) {
      float* wb = w + (size_t)b0 * M * M;
      int nbk = min(B - b0, kMaxGridY * fpb);
      void* args[] = {&wb, &nbk, &M, &lo, &bs, &fpb};
      cudaLaunchKernel(sk, dim3(tiles, (nbk + fpb - 1) / fpb),
                       dim3(fpb * c.ty * c.ty), args, schur_smem(c, fpb),
                       stream);
      if (cudaPeekAtLastError() != cudaSuccess) return;
    }
  }
}

int frontal_factor_kernel_info(int i, int out[8]) {
  if (i < 2) {  // small_kernel at NB = 16, 32
    fill_info(i == 0 ? reinterpret_cast<const void*>(small_kernel<16>)
                     : reinterpret_cast<const void*>(small_kernel<32>),
              3, 16 << i, 1, 0, 32 * kDiagWarps, 0, out);
    return 1;
  }
  i -= 2;
  if (i < 3) {  // diag_kernel at NB = 8, 16, 32
    const int nb = 8 << i;
    fill_info(diag_kernel_ptr(nb), 0, nb, kDiagWarps / diag_fronts(nb), 0,
              32 * kDiagWarps, 0, out);
    return 1;
  }
  if (i < 5) {  // panel_kernel, 16- then 4-byte copies, at its widest
    fill_info(panel_kernel_ptr(i == 3), 1, 0, 0, i == 3, kPanelThreads,
              panel_smem(kMaxPanel, 8, 8), out);
    return 1;
  }
  const int cfg = (i - 5) / 2;
  if (cfg >= kNumSchur) return 0;
  const bool wide = (i - 5) % 2 == 0;
  const SchurConfig& c = kSchur[cfg];
  const int fpb = kSchurThreads / (c.ty * c.ty);
  fill_info(schur_kernel_ptr(cfg, wide), 2, c.tt * c.ty, c.tt, wide,
            fpb * c.ty * c.ty, schur_smem(c, fpb), out);
  return 1;
}
