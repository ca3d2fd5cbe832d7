// Block-ELL sparse matrix times an RHS block: y = A x.
//
// Replaces: repro/kernels/spmv_bell.py `bell_spmv` (pallas_call at :91;
//   body `_bell_kernel` :54).
//
// A is stored as `blocks` (nrb, max_k, bs, bs), dense bs x bs blocks with
// every block-row padded to max_k blocks, and `idx` (nrb, max_k), the column
// block of each. x and y are (nrb * bs, kk), row-major. The sum is taken in
// the element type: fp64 for the refinement residual (the refinement loop
// needs an fp64 residual to reach an fp64 solution).
//
// What bounds it: bytes. Every stored block (padding included) is read once,
// 2 flops per 8-byte entry, far below the line where fp64 arithmetic would
// limit it.
//
// What the design does about it: bs * kk consecutive threads own one
// block-row (8 threads at one RHS, 64 at eight) and each computes one output
// entry over the row's max_k blocks in a fixed order, so the result is the
// same on every run and needs no atomics. The threads of a block-row read
// the row's blocks in consecutive addresses. A block-row loads its own
// column-block indices: there is no scalar prefetch on the card.
#include "kernels.h"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
bell_spmv_kernel(const T* __restrict__ blocks, const int* __restrict__ idx,
                 const T* __restrict__ x, T* __restrict__ y, int nrb,
                 int max_k, int bs, int kk) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_row = (long long)bs * kk;
  if (g >= (long long)nrb * per_row) return;
  const int r = (int)(g / per_row);
  const int rem = (int)(g - r * per_row);
  const int i = rem / kk, c = rem - i * kk;
  T acc = 0;
  for (int k = 0; k < max_k; ++k) {
    const int cb = idx[(size_t)r * max_k + k];
    const T* blk = blocks + (((size_t)r * max_k + k) * bs + i) * bs;
    const T* xb = x + (size_t)cb * bs * kk + c;
    for (int j = 0; j < bs; ++j) acc += blk[j] * xb[(size_t)j * kk];
  }
  y[((size_t)r * bs + i) * kk + c] = acc;
}

template <typename T>
void launch(const T* blocks, const int* idx, const T* x, T* y, int nrb,
            int max_k, int bs, int kk, cudaStream_t stream) {
  const long long total = (long long)nrb * bs * kk;
  if (total == 0) return;
  const int grid = (int)((total + kThreads - 1) / kThreads);
  bell_spmv_kernel<T><<<grid, kThreads, 0, stream>>>(blocks, idx, x, y, nrb,
                                                     max_k, bs, kk);
}

}  // namespace

void launch_bell_spmv_f64(const double* blocks, const int* idx,
                          const double* x, double* y, int nrb, int max_k,
                          int bs, int kk, cudaStream_t stream) {
  launch(blocks, idx, x, y, nrb, max_k, bs, kk, stream);
}

void launch_bell_spmv_f32(const float* blocks, const int* idx, const float* x,
                          float* y, int nrb, int max_k, int bs, int kk,
                          cudaStream_t stream) {
  launch(blocks, idx, x, y, nrb, max_k, bs, kk, stream);
}
