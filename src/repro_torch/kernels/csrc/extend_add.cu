// On-device extend-add: W[dst[c]][rows[c], rows[c]] += U[c], in place.
//
// Replaces: repro/kernels/frontal_cholesky.py `extend_add_batch`
//   (pallas_call at :280; body `_extend_add_kernel` :227).
//
// U[c] is read straight out of the source bucket's factored stack:
// U[c] = u[src[c], off:off+R, off:off+R], so the trailing (Schur) block of
// a factored front feeds its parent without a gather copy. Row-map entries of
// -1 are inert. The active entries of one row map must be distinct (they come
// from np.searchsorted over a front's sorted rows).
//
// What bounds it: bytes. Each active U entry is read once and each touched W
// entry is read and written once, with one add per entry; the writes are a
// scatter through the row map.
//
// What the design does about it: the TPU grid ran in order, so children with
// the same destination accumulated one after another in VMEM. Blocks on the
// card run in parallel, so here each block owns a band of kRows rows of one
// destination slot and walks that slot's contributions in the order of the
// sorted `dst`, with a barrier between contributions: every W entry receives
// its adds in the same order on every run, without float atomics. Within a
// contribution one warp takes one U row whose target row lies in the band,
// and its lanes read that U row with coalesced loads and scatter it along
// the mapped columns. The one-hot E^T U E matmuls of the TPU kernel are gone:
// the scatter is direct.
#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // W rows owned by one block

__global__ void __launch_bounds__(kThreads)
extend_add_kernel(float* __restrict__ w, int M, const float* __restrict__ u,
                  int Mu, int off, const int* __restrict__ src,
                  const int* __restrict__ rows, int R,
                  const int* __restrict__ seg_ptr,
                  const int* __restrict__ seg_dst) {
  extern __shared__ int rmap[];  // R entries: the current row map
  const int s = blockIdx.x;
  const int r0 = blockIdx.y * kRows, r1 = min(r0 + kRows, M);
  float* W = w + (size_t)seg_dst[s] * M * M;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nwarps = blockDim.x / 32;
  for (int c = seg_ptr[s]; c < seg_ptr[s + 1]; ++c) {
    for (int i = tid; i < R; i += blockDim.x) rmap[i] = rows[(size_t)c * R + i];
    __syncthreads();
    const float* U = u + (size_t)src[c] * Mu * Mu + (size_t)off * Mu + off;
    for (int i = warp; i < R; i += nwarps) {
      const int ri = rmap[i];
      if (ri < r0 || ri >= r1) continue;  // outside the band, or inert (-1)
      float* wrow = W + (size_t)ri * M;
      const float* urow = U + (size_t)i * Mu;
      for (int j = lane; j < R; j += 32) {
        const int cj = rmap[j];
        if (cj >= 0) wrow[cj] += urow[j];
      }
    }
    __syncthreads();
  }
}

}  // namespace

void launch_extend_add(float* w, int M, const float* u, int Mu, int off,
                       const int* src, const int* rows, int R,
                       const int* seg_ptr, const int* seg_dst, int nseg,
                       cudaStream_t stream) {
  if (nseg == 0) return;
  const dim3 grid(nseg, (M + kRows - 1) / kRows);
  extend_add_kernel<<<grid, kThreads, R * sizeof(int), stream>>>(
      w, M, u, Mu, off, src, rows, R, seg_ptr, seg_dst);
}
