// Batched blocked triangular substitution: L Y = X (top-down) or
// L^T Y = X (bottom-up), in place on the RHS slabs.
//
// Replaces: repro/kernels/frontal_cholesky.py `tri_solve_batch`
//   (pallas_call at :364; body `_tri_solve_batch_kernel` :289).
//
// `l` holds the lower factor of each front with batch stride `l_bstride` and
// row stride `ldl`, so L11 is read straight out of a factored (B, M, M)
// workspace stack without a copy. Only entries on or below the diagonal are
// read. Unit-diagonal pad rows pass their RHS through.
//
// What bounds it: the sequential chain of the substitution, not bytes or
// flops: a front's P x kt slab needs P dependent steps, and at one RHS
// (kt = 1) there is almost no parallel work per step.
//
// What the design does about it: one block per (front, RHS tile); the
// P x kt slab sits in shared memory (8 KB at P = 256, kt = 8) and the block
// walks the panels of bs <= 32 rows, reading L from device memory. The
// dependent chain inside a panel runs in one warp with register shuffles
// (lane = row of the panel, one warp per RHS column), so each step costs a
// shuffle rather than a block barrier; the update of the rows outside the
// panel is spread over all threads (right-looking in both directions, so the
// L^T update reads rows of L contiguously).
#include "kernels.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
tri_solve_kernel(const float* __restrict__ l, long long l_bstride, int ldl,
                 float* __restrict__ x, int P, int K, int kt, int bs,
                 bool lower) {
  extern __shared__ float X[];  // P x kt, row-major
  const float* L = l + (size_t)blockIdx.x * l_bstride;
  float* xb = x + (size_t)blockIdx.x * P * K;
  const int c0 = blockIdx.y * kt;
  const int kc = min(kt, K - c0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nwarps = blockDim.x / 32;
  const unsigned full = 0xffffffffu;

  for (int e = tid; e < P * kc; e += blockDim.x) {
    const int p = e / kc, cc = e - p * kc;
    X[p * kt + cc] = xb[(size_t)p * K + c0 + cc];
  }
  __syncthreads();

  const int npanels = P / bs;
  for (int t = 0; t < npanels; ++t) {
    const int lo = (lower ? t : npanels - 1 - t) * bs;
    // the panel's own triangle: one warp per RHS column, lane = panel row
    for (int cc = warp; cc < kc; cc += nwarps) {
      float v = lane < bs ? X[(lo + lane) * kt + cc] : 0.f;
      if (lower) {
        for (int j = 0; j < bs; ++j) {
          const float yj = __shfl_sync(full, v, j) / L[(size_t)(lo + j) * ldl + lo + j];
          if (lane == j) v = yj;
          else if (lane > j && lane < bs) v -= L[(size_t)(lo + lane) * ldl + lo + j] * yj;
        }
      } else {
        for (int j = bs - 1; j >= 0; --j) {
          const float yj = __shfl_sync(full, v, j) / L[(size_t)(lo + j) * ldl + lo + j];
          if (lane == j) v = yj;
          else if (lane < j) v -= L[(size_t)(lo + j) * ldl + lo + lane] * yj;
        }
      }
      if (lane < bs) X[(lo + lane) * kt + cc] = v;
    }
    __syncthreads();
    // rows outside the panel: below it (lower) or above it (upper)
    const int r_begin = lower ? lo + bs : 0;
    const int nr = lower ? P - lo - bs : lo;
    for (int e = tid; e < nr * kc; e += blockDim.x) {
      const int r = r_begin + e / kc, cc = e % kc;
      float s = 0.f;
      if (lower) {
        const float* lrow = L + (size_t)r * ldl + lo;
        for (int j = 0; j < bs; ++j) s += lrow[j] * X[(lo + j) * kt + cc];
      } else {
        for (int j = 0; j < bs; ++j)
          s += L[(size_t)(lo + j) * ldl + r] * X[(lo + j) * kt + cc];
      }
      X[r * kt + cc] -= s;
    }
    __syncthreads();
  }

  for (int e = tid; e < P * kc; e += blockDim.x) {
    const int p = e / kc, cc = e - p * kc;
    xb[(size_t)p * K + c0 + cc] = X[p * kt + cc];
  }
}

}  // namespace

void launch_tri_solve(const float* l, long long l_bstride, int ldl, float* x,
                      int B, int P, int K, int kt, int bs, bool lower,
                      cudaStream_t stream) {
  const size_t smem = (size_t)P * kt * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(tri_solve_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    if (cudaPeekAtLastError() != cudaSuccess) return;
  }
  const dim3 grid(B, (K + kt - 1) / kt);
  tri_solve_kernel<<<grid, kThreads, smem, stream>>>(l, l_bstride, ldl, x, P,
                                                     K, kt, bs, lower);
}
