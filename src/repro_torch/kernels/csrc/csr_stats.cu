// Per-matrix structure statistics of a padded CSR batch, for the featurizer.
//
//   entry_stats: over the (B, E) entry batch, bandwidth max |r - c| over the
//     valid entries and profile sum of (r - c) over the first-of-row entries
//     with c < r.
//   row_stats: over the (B, N) row batch, max, min and sum of (cnt - mean)^2
//     of the valid rows' nonzero counts.
//
// Replaces: repro/kernels/csr_stats.py `entry_stats` (pallas_call at :116;
//   body `_entry_kernel` :51) and `row_stats` (pallas_call at :142; body
//   `_row_kernel` :75).
//
// What bounds them: bytes. entry_stats reads four int32 values per padded
// entry and does a handful of integer operations on them; row_stats reads
// two int32 values per padded row. Both are far below the line where
// arithmetic would limit them.
//
// What the design does about it: the TPU walked one matrix's tiles in order
// into a 128-lane accumulator row. Here the grid is (chunks, B): each block
// reduces one contiguous chunk of one matrix with consecutive threads on
// consecutive addresses, then warp shuffles and one shared-memory step, and
// writes one partial per (matrix, chunk), so a batch of 16 padded to
// E = 2^20 puts 4,096 blocks on the card. A second kernel, one block per
// matrix, folds the partials. Every fold has a fixed order and there are no
// float atomics, so the results are the same on every run. Bandwidth and
// the row max/min are exact integers; the profile is summed in int64 (exact,
// and it cannot wrap); the squared deviations (cnt - mean, in f32 as in the
// reference) are squared and summed in fp64 and converted once.
#include <climits>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// identity of the row-count min, as the reference's _ROW_MIN_INIT: a
// matrix with no valid row comes out the same before the caller masks it
constexpr float kRowMinInit = 3.4e38f;

struct MaxOp {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};
struct MinOp {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a < b ? a : b; }
};
struct SumOp {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};

// Reduce v over the block in a fixed order; the result is valid in thread 0.
// `smem` holds kWarps values and is used by this call only.
template <typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, Op op, T identity, T* smem) {
  for (int o = 16; o > 0; o >>= 1)
    v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? smem[lane] : identity;
    for (int o = 16; o > 0; o >>= 1)
      v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
entry_partial_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
                     const int* __restrict__ valid,
                     const int* __restrict__ first, int E, int chunk,
                     int* __restrict__ bw_part,
                     long long* __restrict__ prof_part) {
  const int b = blockIdx.y, c = blockIdx.x, chunks = gridDim.x;
  const size_t base = (size_t)b * E;
  const long long lo = (long long)c * chunk;
  const long long hi = min((long long)E, lo + chunk);
  int bw = 0;
  long long prof = 0;
  for (long long k = lo + threadIdx.x; k < hi; k += kThreads) {
    const int d = rows[base + k] - cols[base + k];
    if (valid[base + k]) bw = max(bw, abs(d));
    if (first[base + k] && d > 0) prof += d;
  }
  __shared__ int s_bw[kWarps];
  __shared__ long long s_prof[kWarps];
  bw = block_reduce(bw, MaxOp(), 0, s_bw);
  prof = block_reduce(prof, SumOp(), 0LL, s_prof);
  if (threadIdx.x == 0) {
    bw_part[(size_t)b * chunks + c] = bw;
    prof_part[(size_t)b * chunks + c] = prof;
  }
}

__global__ void __launch_bounds__(kThreads)
entry_fold_kernel(const int* __restrict__ bw_part,
                  const long long* __restrict__ prof_part, int chunks,
                  float* __restrict__ out) {
  const int b = blockIdx.x;
  int bw = 0;
  long long prof = 0;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    bw = max(bw, bw_part[(size_t)b * chunks + c]);
    prof += prof_part[(size_t)b * chunks + c];
  }
  __shared__ int s_bw[kWarps];
  __shared__ long long s_prof[kWarps];
  bw = block_reduce(bw, MaxOp(), 0, s_bw);
  prof = block_reduce(prof, SumOp(), 0LL, s_prof);
  if (threadIdx.x == 0) {
    out[2 * b] = (float)bw;
    out[2 * b + 1] = (float)prof;
  }
}

__global__ void __launch_bounds__(kThreads)
row_partial_kernel(const int* __restrict__ row_nnz,
                   const int* __restrict__ row_valid,
                   const float* __restrict__ mean, int N, int chunk,
                   int* __restrict__ mx_part, int* __restrict__ mn_part,
                   double* __restrict__ sq_part) {
  const int b = blockIdx.y, c = blockIdx.x, chunks = gridDim.x;
  const size_t base = (size_t)b * N;
  const long long lo = (long long)c * chunk;
  const long long hi = min((long long)N, lo + chunk);
  const float m = mean[b];
  int mx = 0, mn = INT_MAX;
  double sq = 0.0;
  for (long long k = lo + threadIdx.x; k < hi; k += kThreads) {
    if (row_valid[base + k]) {
      const int cnt = row_nnz[base + k];
      mx = max(mx, cnt);
      mn = min(mn, cnt);
      const float d = (float)cnt - m;  // the reference's f32 deviation
      sq += (double)d * (double)d;     // exact square, fp64 sum
    }
  }
  __shared__ int s_mx[kWarps], s_mn[kWarps];
  __shared__ double s_sq[kWarps];
  mx = block_reduce(mx, MaxOp(), 0, s_mx);
  mn = block_reduce(mn, MinOp(), INT_MAX, s_mn);
  sq = block_reduce(sq, SumOp(), 0.0, s_sq);
  if (threadIdx.x == 0) {
    mx_part[(size_t)b * chunks + c] = mx;
    mn_part[(size_t)b * chunks + c] = mn;
    sq_part[(size_t)b * chunks + c] = sq;
  }
}

__global__ void __launch_bounds__(kThreads)
row_fold_kernel(const int* __restrict__ mx_part,
                const int* __restrict__ mn_part,
                const double* __restrict__ sq_part, int chunks,
                float* __restrict__ out) {
  const int b = blockIdx.x;
  int mx = 0, mn = INT_MAX;
  double sq = 0.0;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    mx = max(mx, mx_part[(size_t)b * chunks + c]);
    mn = min(mn, mn_part[(size_t)b * chunks + c]);
    sq += sq_part[(size_t)b * chunks + c];
  }
  __shared__ int s_mx[kWarps], s_mn[kWarps];
  __shared__ double s_sq[kWarps];
  mx = block_reduce(mx, MaxOp(), 0, s_mx);
  mn = block_reduce(mn, MinOp(), INT_MAX, s_mn);
  sq = block_reduce(sq, SumOp(), 0.0, s_sq);
  if (threadIdx.x == 0) {
    out[3 * b] = (float)mx;
    out[3 * b + 1] = mn == INT_MAX ? kRowMinInit : (float)mn;
    out[3 * b + 2] = (float)sq;
  }
}

int num_chunks(int len, int chunk) {
  return (int)(((long long)len + chunk - 1) / chunk);
}

}  // namespace

void launch_entry_stats(const int* rows, const int* cols, const int* valid,
                        const int* first, int B, int E, int chunk,
                        int* bw_part, int64_t* prof_part, float* out,
                        cudaStream_t stream) {
  if (B == 0) return;
  const int chunks = num_chunks(E, chunk);
  auto* prof = reinterpret_cast<long long*>(prof_part);
  if (chunks > 0) {
    entry_partial_kernel<<<dim3(chunks, B), kThreads, 0, stream>>>(
        rows, cols, valid, first, E, chunk, bw_part, prof);
    if (cudaPeekAtLastError() != cudaSuccess) return;
  }
  entry_fold_kernel<<<B, kThreads, 0, stream>>>(bw_part, prof, chunks, out);
}

void launch_row_stats(const int* row_nnz, const int* row_valid,
                      const float* mean, int B, int N, int chunk,
                      int* mx_part, int* mn_part, double* sq_part, float* out,
                      cudaStream_t stream) {
  if (B == 0) return;
  const int chunks = num_chunks(N, chunk);
  if (chunks > 0) {
    row_partial_kernel<<<dim3(chunks, B), kThreads, 0, stream>>>(
        row_nnz, row_valid, mean, N, chunk, mx_part, mn_part, sq_part);
    if (cudaPeekAtLastError() != cudaSuccess) return;
  }
  row_fold_kernel<<<B, kThreads, 0, stream>>>(mx_part, mn_part, sq_part,
                                              chunks, out);
}
