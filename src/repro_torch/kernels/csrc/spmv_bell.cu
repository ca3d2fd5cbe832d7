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
// What bounds it: bytes. Every stored block, ELL padding included, and every
// idx entry are read once, x is gathered and y written once: 2 flops per
// 8-byte entry, far below the line where fp64 arithmetic would limit it, so
// the tensor cores stay unused. The block size sets the bytes (bs = 8 pads a
// 3-D mesh 24x over its CSR); the caller picks it (pick_spmv_bs).
//
// What the design does about it: a block-row's blocks are one contiguous
// run of max_k * bs * bs values, and a segment of G lanes (a power of two up
// to the warp, from the run's length) streams it. With bs in {1, 2, 4, 8} a
// compile-time constant, a lane loads two neighbouring values of one row of
// a block at once (16 bytes at fp64; one value, 8 bytes, at bs = 1), lanes
// in order of address, so every load instruction of a warp reads one
// contiguous span, up to four steps in flight a lane, and each idx entry is
// read by the lanes of its block in the same instruction. A lane therefore
// always meets the same place (row i, columns j, j + 1) of its blocks: it
// keeps one sum per RHS column in registers, gathers x rows j, j + 1 of the
// block's column through the read-only path (in pairs where aligned), and
// the segment adds its lanes' sums with a fixed butterfly of shuffles. A
// row of any max_k is walked in steps of G lanes. Any other bs takes the
// generic kernel: a warp per block-row stages the run in shared memory in
// chunks, read with the same coalesced pattern, and a lane sums each (row,
// RHS column) from there. RHS columns go in tiles of 8 (a grid dimension).
// Every sum runs in a fixed order, with no atomics, so a call gives the
// same result on every run.
#include "kernels.h"

namespace {

constexpr int kThreads = 256;  // threads a block, segment kernel
constexpr int kTile = 8;       // RHS columns a pass keeps in registers
constexpr int kGenThreads = 128;
constexpr int kStage = 512;    // values the generic kernel stages a warp

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v / 2);
}

// Two neighbouring values in one load (16 bytes at fp64, 8 at fp32); p is
// aligned to twice the element.
__device__ __forceinline__ void load2(const double* p, double& a, double& b) {
  const double2 t = __ldg(reinterpret_cast<const double2*>(p));
  a = t.x;
  b = t.y;
}
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(p));
  a = t.x;
  b = t.y;
}

// Whether a whole RHS tile may be read in pairs.
__device__ __forceinline__ bool vec_ok(bool xvec, int kt, int KT) {
  return KT % 2 == 0 && xvec && kt == KT;
}

// The KT columns from c0 of x rows `row` .. row + V - 1 (masked past kt).
// `vec`: pairs of them may be loaded at once (x aligned; kk = 1 with row
// even, or kk even).
template <typename T, int V, int KT>
__device__ __forceinline__ void load_x(const T* __restrict__ x, size_t row,
                                       int kk, int c0, int kt, bool vec,
                                       T (&xv)[V][KT]) {
  if (KT == 1 && V == 2 && vec) {
    load2(x + row, xv[0][0], xv[V - 1][0]);
    return;
  }
#pragma unroll
  for (int w = 0; w < V; ++w) {
    const T* xr = x + (row + w) * kk + c0;
    if (vec_ok(vec, kt, KT)) {
#pragma unroll
      for (int c = 0; c < KT; c += 2) load2(xr + c, xv[w][c], xv[w][c + 1]);
    } else {
#pragma unroll
      for (int c = 0; c < KT; ++c) xv[w][c] = c < kt ? __ldg(xr + c) : T(0);
    }
  }
}

// Step loads of a lane: the V values of its slots t0, t0 + G, ... (U of
// them) and their blocks' column blocks; slots at or past nl load nothing.
template <typename T, int V, int LB, int U>
__device__ __forceinline__ void load_step(const T* __restrict__ rowv,
                                          const int* __restrict__ rowi,
                                          long long t0, int G, long long nl,
                                          T (&v)[U][V], int (&cb)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long t = t0 + (long long)u * G;
    cb[u] = 0;
#pragma unroll
    for (int w = 0; w < V; ++w) v[u][w] = T(0);
    if (t < nl) {
      if (V == 2)
        load2(rowv + t * V, v[u][0], v[u][V - 1]);
      else
        v[u][0] = __ldg(rowv + t);
      cb[u] = __ldg(rowi + (t >> log2i(LB)));
    }
  }
}

// bs in {1, 2, 4, 8}: a segment of G lanes per block-row. A lane loads V
// neighbouring values of one row of a block (V = 2 for bs >= 2, 1 at bs =
// 1), so LB = bs * bs / V lanes cover a block and lane l always meets the
// same place (i, j) in its blocks; U steps of G slots are in flight.
template <typename T, int BS, int KT, int U>
__global__ void __launch_bounds__(kThreads, KT > 1 ? 2 : U == 1 ? 8 : 4)
bell_segment_kernel(const T* __restrict__ blocks, const int* __restrict__ idx,
                    const T* __restrict__ x, T* __restrict__ y, int nrb,
                    int max_k, int kk, int log_g, bool xvec) {
  constexpr int V = BS == 1 ? 1 : 2;
  constexpr int LB = BS * BS / V;  // lanes a block
  constexpr int JL = BS / V;       // lanes a row of a block
  const int G = 1 << log_g;        // G >= LB
  const int l = threadIdx.x & (G - 1);
  const long long seg =
      ((long long)blockIdx.x * kThreads + threadIdx.x) >> log_g;
  // a segment past the last block-row loads nothing (nl = 0) but walks the
  // same steps as the rest of its warp
  const long long nl = seg < nrb ? (long long)max_k * LB : 0;
  const size_t r = seg < nrb ? (size_t)seg : 0;
  const T* rowv = blocks + r * max_k * BS * BS;
  const int* rowi = idx + r * max_k;
  const int m = l & (LB - 1);  // the lane's place in a block
  const int i = m / JL, j = (m % JL) * V;

  for (int c0 = blockIdx.y * KT; c0 < kk; c0 += gridDim.y * KT) {
    const int kt = min(KT, kk - c0);
    T acc[KT];
#pragma unroll
    for (int c = 0; c < KT; ++c) acc[c] = T(0);

    for (long long b0 = 0; b0 < (long long)max_k * LB;
         b0 += (long long)G * U) {
      T v[U][V];
      int cb[U];
      load_step<T, V, LB, U>(rowv, rowi, b0 + l, G, nl, v, cb);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (b0 + (long long)u * G + l >= nl) break;
        T xv[V][KT];
        load_x<T, V, KT>(x, (size_t)cb[u] * BS + j, kk, c0, kt, xvec, xv);
#pragma unroll
        for (int c = 0; c < KT; ++c)
#pragma unroll
          for (int w = 0; w < V; ++w) acc[c] += v[u][w] * xv[w][c];
      }
    }

    // add the sums of the lanes that share an output row: those that
    // differ in the bits of j and, where a step covers several blocks, of
    // the block (the bits from LB up to G)
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      T a = acc[c];
#pragma unroll
      for (int off = 1; off < JL; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      for (int off = LB; off < G; off <<= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      acc[c] = a;
    }
    if (seg < nrb && l < LB && j == 0) {
      T* yr = y + (r * BS + i) * kk + c0;
#pragma unroll
      for (int c = 0; c < KT; ++c)
        if (c < kt) yr[c] = acc[c];
    }
  }
}

// Any bs: a warp per (block-row, RHS tile). The warp stages the block-row's
// run in shared memory kStage values at a time, and lane o sums output row
// o / kt, column o % kt over the staged blocks in order of block and column.
template <typename T>
__global__ void __launch_bounds__(kGenThreads)
bell_generic_kernel(const T* __restrict__ blocks, const int* __restrict__ idx,
                    const T* __restrict__ x, T* __restrict__ y, int nrb,
                    int max_k, int bs, int kk) {
  constexpr int W = kGenThreads / 32;
  __shared__ __align__(16) unsigned char buf[W * kStage * sizeof(T)];
  const int lane = threadIdx.x & 31;
  T* stage = reinterpret_cast<T*>(buf) + (threadIdx.x / 32) * kStage;
  const long long r = (long long)blockIdx.x * W + threadIdx.x / 32;
  if (r >= nrb) return;
  const long long E = (long long)bs * bs, nv = (long long)max_k * E;
  const T* rowv = blocks + (size_t)r * nv;
  const int* rowi = idx + (size_t)r * max_k;
  for (int c0 = blockIdx.y * kTile; c0 < kk; c0 += gridDim.y * kTile) {
    const int kt = min(kTile, kk - c0);
    const int nout = bs * kt;
    for (int o0 = 0; o0 < nout; o0 += 32) {
      const int o = o0 + lane;
      const int i = o / kt, c = o - i * kt;
      T acc = T(0);
      for (long long v0 = 0; v0 < nv; v0 += kStage) {
        const int len = (int)min((long long)kStage, nv - v0);
        __syncwarp();
        for (int q = lane; q < len; q += 32) stage[q] = __ldg(rowv + v0 + q);
        __syncwarp();
        if (o >= nout) continue;
        // row i of block k holds values [k E + i bs, k E + i bs + bs)
        for (long long k = v0 / E; k * E < v0 + len; ++k) {
          const long long s0 = k * E + (long long)i * bs;
          const long long a = max(s0, v0), b = min(s0 + bs, v0 + len);
          const T* xr =
              x + ((size_t)__ldg(rowi + k) * bs + (a - s0)) * kk + c0 + c;
          for (long long p = a; p < b; ++p, xr += kk)
            acc += stage[p - v0] * __ldg(xr);
        }
      }
      if (o < nout) y[((size_t)r * bs + i) * kk + c0 + c] = acc;
    }
  }
}

// Lanes a block-row: the run's lane slots (values / V) rounded up to a
// power of two, at least a block's, at most a warp.
int segment_log(int bs, int max_k) {
  const int v = bs == 1 ? 1 : 2;
  const long long want = (long long)max_k * bs * bs / v;
  int lg = log2i(bs * bs / v);
  while (lg < 5 && (1LL << lg) < want) ++lg;
  return lg;
}

// Whether a whole run fits in one step of its segment: then one step a
// loop (U = 1) keeps registers, and so the blocks in flight, up.
bool one_step(int bs, int max_k) {
  const int v = bs == 1 ? 1 : 2;
  return (long long)max_k * bs * bs / v <= (1LL << segment_log(bs, max_k));
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

unsigned tiles_y(int kk) {
  const int tiles = (kk + kTile - 1) / kTile;
  return tiles < 65535 ? tiles : 65535;
}

template <typename T, int BS>
const void* segment_kernel(int kk, bool one) {
  if (kk == 1)
    return one ? (const void*)bell_segment_kernel<T, BS, 1, 1>
               : (const void*)bell_segment_kernel<T, BS, 1, 4>;
  return one ? (const void*)bell_segment_kernel<T, BS, kTile, 1>
             : (const void*)bell_segment_kernel<T, BS, kTile, 4>;
}

// The kernel launch() runs for (bs, kk, max_k), or nullptr for the generic.
template <typename T>
const void* pick(int bs, int kk, int max_k) {
  const bool one = one_step(bs, max_k);
  switch (bs) {
    case 1: return segment_kernel<T, 1>(kk, one);
    case 2: return segment_kernel<T, 2>(kk, one);
    case 4: return segment_kernel<T, 4>(kk, one);
    case 8: return segment_kernel<T, 8>(kk, one);
    default: return nullptr;
  }
}

template <typename T>
void launch(const T* blocks, const int* idx, const T* x, T* y, int nrb,
            int max_k, int bs, int kk, cudaStream_t stream) {
  if ((long long)nrb * bs * kk == 0) return;
  const void* fn = pick<T>(bs, kk, max_k);
  // the segment kernel's paired loads need 2-element alignment of blocks
  if (fn != nullptr && (bs == 1 || aligned(blocks, 2 * sizeof(T)))) {
    const int lg = segment_log(bs, max_k);
    const bool xvec = aligned(x, 2 * sizeof(T)) && (kk == 1 || kk % 2 == 0);
    void* args[] = {&blocks, &idx, &x, &y, &nrb, &max_k, &kk,
                    const_cast<int*>(&lg), const_cast<bool*>(&xvec)};
    const dim3 grid((unsigned)((((long long)nrb << lg) + kThreads - 1) /
                               kThreads),
                    tiles_y(kk));
    cudaLaunchKernel(fn, grid, dim3(kThreads), args, 0, stream);
    return;
  }
  constexpr int W = kGenThreads / 32;
  bell_generic_kernel<T><<<dim3((nrb + W - 1) / W, tiles_y(kk)), kGenThreads,
                           0, stream>>>(blocks, idx, x, y, nrb, max_k, bs,
                                        kk);
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

void bell_spmv_kernel_info(int bs, int kk, bool fp64, int max_k, int out[5]) {
  const void* fn =
      fp64 ? pick<double>(bs, kk, max_k) : pick<float>(bs, kk, max_k);
  const bool seg = fn != nullptr;
  if (!seg)
    fn = fp64 ? (const void*)bell_generic_kernel<double>
              : (const void*)bell_generic_kernel<float>;
  cudaFuncAttributes a{};
  cudaFuncGetAttributes(&a, fn);
  out[0] = seg;
  out[1] = seg ? 1 << segment_log(bs, max_k) : 32;
  out[2] = a.numRegs;
  out[3] = static_cast<int>(a.sharedSizeBytes);
  out[4] = static_cast<int>(a.localSizeBytes);
}
