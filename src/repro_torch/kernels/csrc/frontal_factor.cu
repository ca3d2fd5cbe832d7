// Batched partial Cholesky of front workspaces, in place.
//
// Replaces: repro/kernels/frontal_cholesky.py `frontal_factor_batch`
//   (pallas_call at :391; body `_frontal_batch_kernel` :196, `_chol_block`
//   :66, `_tri_inv_block` :84).
//
// Computes, for each (M, M) f32 front of the (B, M, M) stack, the blocked
// right-looking partial Cholesky of the leading `npiv` columns in panels of
// `bs` columns: L11 (lower, zeros above the diagonal inside each diagonal
// tile) and L21 in the pivot columns, the Schur complement in the trailing
// block. Only the lower triangle is read and only the lower triangle is
// authoritative; tiles wholly above the diagonal of the trailing block are
// not updated. Identity pad pivots factor to 1.
//
// What bounds it: a front reaches M = 1280 on a 3-D grid, 6.5 MB in f32, so
// it cannot live in one block's 227 KB of shared memory the way the TPU kernel
// kept a whole front in VMEM. Each panel re-reads and re-writes the trailing
// block from device memory: for bs = 32 that is 8 bytes per 64 flops, so the
// Schur update sits near the line between memory and fp32 CUDA-core rate, and
// at the top of the tree (B = 1) the sequential panel chain and launch latency
// bound it.
//
// What the design does about it: the front stays in the global workspace and
// is updated in place one panel at a time, with two kernels per panel.
//   1. panel_kernel, one block per front: factors the bs x bs diagonal tile
//      in shared memory and forward-substitutes the rows below it
//      (L21 = W L11^-T), staging 256 rows at a time in shared memory so that
//      device-memory reads and writes are coalesced.
//   2. schur_kernel, a (lower-triangle tiles, B) grid of 64 x 64 tiles: the
//      rank-bs update S -= L21 L21^T, so even a single root front spreads over
//      as many blocks as its trailing block has lower tiles.
// Simple and right first: no tensor cores, no cp.async; both are later work.
#include "kernels.h"

namespace {

constexpr int kPanelThreads = 256;
constexpr int kTile = 64;
constexpr int kSchurThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kPanelThreads)
panel_kernel(float* __restrict__ w, int M, int lo, int bs) {
  __shared__ float T[kMaxPanel][kMaxPanel + 1];
  __shared__ float X[kPanelThreads][kMaxPanel + 1];
  float* W = w + (size_t)blockIdx.x * M * M;
  const int tid = threadIdx.x;

  for (int e = tid; e < bs * bs; e += blockDim.x) {
    const int i = e / bs, j = e - i * bs;
    T[i][j] = j <= i ? W[(size_t)(lo + i) * M + lo + j] : 0.f;
  }
  __syncthreads();
  // unblocked right-looking Cholesky of the diagonal tile (lower triangle)
  for (int j = 0; j < bs; ++j) {
    const float d = sqrtf(T[j][j]);
    __syncthreads();
    if (tid == 0) T[j][j] = d;
    for (int i = j + 1 + tid; i < bs; i += blockDim.x) T[i][j] /= d;
    __syncthreads();
    const int nt = bs - j - 1;
    for (int e = tid; e < nt * nt; e += blockDim.x) {
      const int i = j + 1 + e / nt, k = j + 1 + e % nt;
      if (k <= i) T[i][k] -= T[i][j] * T[k][j];
    }
    __syncthreads();
  }
  for (int e = tid; e < bs * bs; e += blockDim.x) {
    const int i = e / bs, j = e - i * bs;
    W[(size_t)(lo + i) * M + lo + j] = j <= i ? T[i][j] : 0.f;
  }
  // rows below the tile: solve y L11^T = x, one thread per row
  for (int base = lo + bs; base < M; base += kPanelThreads) {
    const int nrows = min(kPanelThreads, M - base);
    for (int e = tid; e < nrows * bs; e += blockDim.x) {
      const int r = e / bs, j = e - r * bs;
      X[r][j] = W[(size_t)(base + r) * M + lo + j];
    }
    __syncthreads();
    if (tid < nrows) {
      for (int j = 0; j < bs; ++j) {
        float s = X[tid][j];
        for (int k = 0; k < j; ++k) s -= X[tid][k] * T[j][k];
        X[tid][j] = s / T[j][j];
      }
    }
    __syncthreads();
    for (int e = tid; e < nrows * bs; e += blockDim.x) {
      const int r = e / bs, j = e - r * bs;
      W[(size_t)(base + r) * M + lo + j] = X[r][j];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kSchurThreads)
schur_kernel(float* __restrict__ w, int M, int lo, int bs) {
  __shared__ float A[kTile][kMaxPanel + 1];
  __shared__ float Bt[kTile][kMaxPanel + 1];
  const int s0 = lo + bs;
  // blockIdx.x enumerates the lower-triangle tiles (ti >= tk) row by row
  const int t = blockIdx.x;
  int ti = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  while (ti * (ti + 1) / 2 > t) --ti;
  const int tk = t - ti * (ti + 1) / 2;
  const int r0 = s0 + ti * kTile, c0 = s0 + tk * kTile;
  float* W = w + (size_t)blockIdx.y * M * M;
  const int tid = threadIdx.x;

  for (int e = tid; e < kTile * bs; e += blockDim.x) {
    const int r = e / bs, j = e - r * bs;
    A[r][j] = r0 + r < M ? W[(size_t)(r0 + r) * M + lo + j] : 0.f;
    Bt[r][j] = c0 + r < M ? W[(size_t)(c0 + r) * M + lo + j] : 0.f;
  }
  __syncthreads();
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4] = {};
  for (int k = 0; k < bs; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = A[ty + 16 * q][k];
      b[q] = Bt[tx + 16 * q][k];
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] += a[p] * b[q];
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = r0 + ty + 16 * p;
    if (r >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + tx + 16 * q;
      if (c < M) W[(size_t)r * M + c] -= acc[p][q];
    }
  }
}

}  // namespace

void launch_frontal_factor(float* w, int B, int M, int npiv, int bs,
                           cudaStream_t stream) {
  for (int lo = 0; lo < npiv; lo += bs) {
    panel_kernel<<<B, kPanelThreads, 0, stream>>>(w, M, lo, bs);
    if (cudaPeekAtLastError() != cudaSuccess) return;
    const int nb = M - lo - bs;
    if (nb <= 0) continue;
    const int nt = (nb + kTile - 1) / kTile;
    for (int b0 = 0; b0 < B; b0 += kMaxGridY) {
      const dim3 grid(nt * (nt + 1) / 2, min(kMaxGridY, B - b0));
      schur_kernel<<<grid, kSchurThreads, 0, stream>>>(
          w + (size_t)b0 * M * M, M, lo, bs);
      if (cudaPeekAtLastError() != cudaSuccess) return;
    }
  }
}
