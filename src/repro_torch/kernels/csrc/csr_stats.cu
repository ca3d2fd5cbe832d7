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
// two int32 values per padded row (16.8 MB for the served batch of 16 at
// N = 2^17: 0.0050 ms at the H100 SXM's
// 3.35 TB/s). Both are far below the line where
// arithmetic would limit them.
//
// What the design does about it. entry_stats: the TPU walked one matrix's
// tiles in order into a 128-lane accumulator row. Here the grid is
// (chunks, B): each block reduces one contiguous chunk of one matrix with
// consecutive threads on consecutive addresses, then warp shuffles and one
// shared-memory step, and writes one partial per (matrix, chunk), so a
// batch of 16 padded to E = 2^20 puts 4,096 blocks on the card; a second
// kernel, one block per matrix, folds the partials.
// row_stats is one pass in one launch over a (chunks, B) grid of 8,192-row
// chunks: each thread keeps eight 16-byte loads of each array in flight, so
// the whole batch is in flight at once, and the last block of a matrix to
// finish folds that matrix's partials. It learns that it is last from an
// integer arrival counter per matrix (an atomic add after a fence that
// publishes its partial) and sets the counter back to zero for the next
// call; the wrapper keeps one zeroed counter buffer per device and stream.
//
// Every fold reads its partials in chunk order through a fixed tree and
// there are no float atomics, so the results are the same on every run,
// whichever block folds. Bandwidth and the row max/min are exact integers;
// the profile is summed in int64 (exact, and it cannot wrap); the squared
// deviations (cnt - mean, in f32 as in the reference) are squared and
// summed in fp64 and converted once.
#include <climits>
#include <cstdint>

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

// A matrix's running row statistics.
struct RowAcc {
  int mx, mn;
  double sq;
  static __device__ __forceinline__ RowAcc identity() {
    RowAcc a;
    a.mx = 0;
    a.mn = INT_MAX;
    a.sq = 0.0;
    return a;
  }
  __device__ __forceinline__ void take(int cnt, int valid, float m) {
    if (valid) {
      mx = max(mx, cnt);
      mn = min(mn, cnt);
      const float d = (float)cnt - m;  // the reference's f32 deviation
      sq += (double)d * (double)d;     // exact square, fp64 sum
    }
  }
  __device__ __forceinline__ void take4(int4 cnt, int4 valid, float m) {
    take(cnt.x, valid.x, m);
    take(cnt.y, valid.y, m);
    take(cnt.z, valid.z, m);
    take(cnt.w, valid.w, m);
  }
  __device__ __forceinline__ void fold(const RowAcc& o) {
    mx = max(mx, o.mx);
    mn = min(mn, o.mn);
    sq += o.sq;
  }
  __device__ __forceinline__ void fold_down(int o) {
    mx = max(mx, __shfl_down_sync(0xffffffffu, mx, o));
    mn = min(mn, __shfl_down_sync(0xffffffffu, mn, o));
    sq += __shfl_down_sync(0xffffffffu, sq, o);
  }
};

// The three statistics reduced over the block together, in a fixed order;
// the result is valid in thread 0. `s` holds kWarps values.
__device__ __forceinline__ RowAcc block_fold(RowAcc a, RowAcc* s) {
  for (int o = 16; o > 0; o >>= 1) a.fold_down(o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? s[lane] : RowAcc::identity();
    for (int o = 16; o > 0; o >>= 1) a.fold_down(o);
  }
  return a;
}

constexpr int kRowUnroll = 8;  // 16-byte loads of each array in flight a thread

// Grid (chunks, B). Block (c, b) reduces chunk c of matrix b's rows and
// publishes its partial; the last block of matrix b to arrive folds the
// matrix's partials in chunk order, writes its result and resets
// arrived[b]. VEC: 16-byte loads, which needs row_nnz and row_valid at the
// same offset from a 16-byte boundary; a matrix's rows before its first
// boundary (N % 4 != 0 puts later matrices off one) and after its last are
// taken one a thread by the last chunk's block.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const int* __restrict__ row_nnz,
                 const int* __restrict__ row_valid,
                 const float* __restrict__ mean, int N, int chunk,
                 int* __restrict__ mx_part, int* __restrict__ mn_part,
                 double* __restrict__ sq_part, unsigned* __restrict__ arrived,
                 float* __restrict__ out) {
  const int b = blockIdx.y, c = blockIdx.x, chunks = gridDim.x;
  const int* nnz = row_nnz + (size_t)b * N;
  const int* val = row_valid + (size_t)b * N;
  const float m = mean[b];
  RowAcc acc = RowAcc::identity();
  if constexpr (VEC) {
    const int head = min(
        N, (int)((16u - (reinterpret_cast<uintptr_t>(nnz) & 15u)) & 15u) / 4);
    const int nbody = (N - head) / 4;  // int4s
    const int4* n4 = reinterpret_cast<const int4*>(nnz + head);
    const int4* v4 = reinterpret_cast<const int4*>(val + head);
    const long long q0 = (long long)c * (chunk / 4);
    const long long q1 = min((long long)nbody, q0 + chunk / 4);
    for (long long q = q0 + threadIdx.x; q < q1;
         q += kThreads * kRowUnroll) {
      int4 x[kRowUnroll], y[kRowUnroll];
#pragma unroll
      for (int k = 0; k < kRowUnroll; ++k) {
        const long long qk = q + k * kThreads;
        x[k] = qk < q1 ? __ldg(n4 + qk) : make_int4(0, 0, 0, 0);
        y[k] = qk < q1 ? __ldg(v4 + qk) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int k = 0; k < kRowUnroll; ++k) acc.take4(x[k], y[k], m);
    }
    if (c == chunks - 1) {
      const int tail = head + 4 * nbody, t = threadIdx.x;
      if (t < head) acc.take(nnz[t], val[t], m);
      if (t >= 32 && tail + t - 32 < N)
        acc.take(nnz[tail + t - 32], val[tail + t - 32], m);
    }
  } else {
    const long long lo = (long long)c * chunk;
    const long long hi = min((long long)N, lo + chunk);
    for (long long k = lo + threadIdx.x; k < hi; k += kThreads)
      acc.take(nnz[k], val[k], m);
  }
  __shared__ RowAcc s[kWarps];
  __shared__ bool last;
  acc = block_fold(acc, s);
  const size_t part = (size_t)b * chunks;
  if (threadIdx.x == 0) {
    mx_part[part + c] = acc.mx;
    mn_part[part + c] = acc.mn;
    sq_part[part + c] = acc.sq;
    __threadfence();  // the partial before the arrival
    last = atomicAdd(arrived + b, 1u) == (unsigned)chunks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // every other block's partial is visible past here
  acc = RowAcc::identity();
  for (int k = threadIdx.x; k < chunks; k += kThreads) {
    RowAcc o;
    o.mx = __ldcg(mx_part + part + k);
    o.mn = __ldcg(mn_part + part + k);
    o.sq = __ldcg(sq_part + part + k);
    acc.fold(o);
  }
  acc = block_fold(acc, s);
  if (threadIdx.x == 0) {
    out[3 * b] = (float)acc.mx;
    out[3 * b + 1] = acc.mn == INT_MAX ? kRowMinInit : (float)acc.mn;
    out[3 * b + 2] = (float)acc.sq;
    arrived[b] = 0;  // ready for the next call on this stream
  }
}

const void* row_kernel_of(bool vec) {
  return vec ? reinterpret_cast<const void*>(row_stats_kernel<true>)
             : reinterpret_cast<const void*>(row_stats_kernel<false>);
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
                      int* mx_part, int* mn_part, double* sq_part,
                      unsigned* arrived, float* out, cudaStream_t stream) {
  if (B == 0) return;
  const int chunks = N > 0 ? num_chunks(N, chunk) : 1;
  const bool vec = chunk % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(row_nnz) -
                     reinterpret_cast<uintptr_t>(row_valid)) & 15u) == 0;
  const dim3 grid(chunks, B);
  if (vec)
    row_stats_kernel<true><<<grid, kThreads, 0, stream>>>(
        row_nnz, row_valid, mean, N, chunk, mx_part, mn_part, sq_part,
        arrived, out);
  else
    row_stats_kernel<false><<<grid, kThreads, 0, stream>>>(
        row_nnz, row_valid, mean, N, chunk, mx_part, mn_part, sq_part,
        arrived, out);
}

int row_stats_kernel_info(int i, int out[5]) {
  if (i < 0 || i > 1) return 0;
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, row_kernel_of(i == 1));
  out[0] = i;
  out[1] = kThreads;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 1;
}
