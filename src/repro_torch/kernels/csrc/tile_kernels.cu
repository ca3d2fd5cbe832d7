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
// update S -= L21 L21^T.
//
// What bounds them: chol_tile and tri_inv_tile are chains of bs dependent
// steps on one 128 x 128 tile (0.7 MFLOP each, 33 KB read, 64 KB written),
// so their time is the chain's latency, not bytes or flops; on the path they
// are also far below the launch and host round trip of each front.
// matmul_nt is fp32 FMA work: K = 128 gives 32 flops per byte of A and B,
// above the line between memory and the CUDA cores' fp32 rate, so its bound
// is operations.
//
// What the designs do about it (one block of 1,024 threads per tile, the
// tile in shared memory):
//   * chol_tile: blocked in panels of 32 columns, so the dependent chain is
//     four 32-step factorizations of diagonal blocks, each in one warp's
//     registers with shuffles; the rows below each block and the trailing
//     update spread over all threads, with a block barrier between the three
//     parts of a panel.
//   * tri_inv_tile: the columns of Y = L^-1 are independent forward
//     substitutions (y_r[c] = (e_r[c] - L[r, :r] Y[:r, c]) / L[r, r]), so a
//     column needs no other column; eight threads of a warp share each
//     column's sums and walk its rows in order with warp shuffles, with no
//     block barrier (L and Y take 129 KB of shared memory at bs = 128).
//   * matmul_nt: a shared-memory-tiled SGEMM, 64 x 64 outputs a block,
//     4 x 4 a thread, K in steps of 16, plain FP32 FMAs (no TF32, no wgmma).
// Simple and right first; the tensor cores and cp.async are later work.
#include "kernels.h"

namespace {

constexpr int kTileThreads = 1024;
constexpr int kPanel = 32;  // the column panel of chol_tile, one warp wide
constexpr int kParts = 8;   // threads sharing one column of tri_inv_tile

// Cholesky of one (bs, bs) tile, blocked in panels of 32 columns. Reads the
// lower triangle of `a` (row stride lda) only; writes L with zeros above the
// diagonal into the contiguous `l`. The tile lives in shared memory with
// rows of bs + 1 floats, so threads on neighbouring rows hit distinct banks.
// Per panel: (1) warp 0 factors the 32 x 32 diagonal block right-looking,
// lane = row, the row in registers and the column broadcast by shuffles
// (rows past the tile are identity rows, which factor to themselves);
// (2) one thread per row below solves that row against the block
// (L21 = A21 L11^-T), the row in registers; (3) all threads apply the
// rank-32 update to the lower trailing triangle. Divisions by the pivot are
// multiplications by its reciprocal, so zeros (identity-padded tiles) take
// no slow path. A non-positive pivot gives NaN through sqrtf, as the
// reference does.
__global__ void __launch_bounds__(kTileThreads)
chol_tile_kernel(const float* __restrict__ a, int lda, float* __restrict__ l,
                 int bs) {
  extern __shared__ float S[];  // bs x (bs + 1), then kPanel reciprocals
  const int ld = bs + 1;
  float* rdiag = S + bs * ld;
  const int tid = threadIdx.x, lane = tid % 32;
  const unsigned full = 0xffffffffu;

  for (int e = tid; e < bs * bs; e += kTileThreads) {
    const int i = e / bs, k = e - i * bs;
    S[i * ld + k] = k <= i ? a[(size_t)i * lda + k] : 0.f;
  }
  __syncthreads();

  for (int p0 = 0; p0 < bs; p0 += kPanel) {
    const int nb = min(kPanel, bs - p0);
    float* D = S + p0 * ld + p0;  // the diagonal block, row stride ld
    if (tid < 32) {
      float r[kPanel];
#pragma unroll
      for (int k = 0; k < kPanel; ++k)
        r[k] = lane < nb ? (k <= lane ? D[lane * ld + k] : 0.f)
                         : (k == lane ? 1.f : 0.f);
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        const float d = sqrtf(__shfl_sync(full, r[j], j));
        if (lane == j) r[j] = d;
        else if (lane > j) r[j] *= 1.f / d;
#pragma unroll
        for (int k = j + 1; k < kPanel; ++k) {
          const float lkj = __shfl_sync(full, r[j], k);
          if (lane >= k) r[k] -= r[j] * lkj;
        }
      }
      if (lane < nb) {
#pragma unroll
        for (int k = 0; k < kPanel; ++k)
          if (k <= lane) D[lane * ld + k] = r[k];
        rdiag[lane] = 1.f / r[lane];
      }
    }
    __syncthreads();
    const int r0 = p0 + nb, n2 = bs - r0;
    for (int row = r0 + tid; row < bs; row += kTileThreads) {
      float* x = S + row * ld + p0;
      float v[kPanel];
#pragma unroll
      for (int j = 0; j < kPanel; ++j) v[j] = j < nb ? x[j] : 0.f;
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        if (j < nb) {
          float t = v[j];
#pragma unroll
          for (int k = 0; k < j; ++k) t -= v[k] * D[j * ld + k];
          v[j] = t * rdiag[j];
        }
      }
#pragma unroll
      for (int j = 0; j < kPanel; ++j)
        if (j < nb) x[j] = v[j];
    }
    __syncthreads();
    for (int e = tid; e < n2 * n2; e += kTileThreads) {
      const int i = e / n2, k = e - i * n2;
      if (k > i) continue;
      const float* si = S + (r0 + i) * ld + p0;
      const float* sk = S + (r0 + k) * ld + p0;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int t = 0; t < kPanel; t += 2) {
        if (t < nb) s0 += si[t] * sk[t];
        if (t + 1 < nb) s1 += si[t + 1] * sk[t + 1];
      }
      S[(r0 + i) * ld + r0 + k] -= s0 + s1;
    }
    __syncthreads();
  }

  for (int e = tid; e < bs * bs; e += kTileThreads) {
    const int i = e / bs, k = e - i * bs;
    l[e] = k <= i ? S[i * ld + k] : 0.f;
  }
}

// Inverse of a lower-triangular (bs, bs) tile (row stride ldl; the lower
// triangle is read), written to the contiguous `y`. The columns of Y are
// independent forward substitutions, y_r[c] = (e_r[c] - L[r, :r] Y[:r, c])
// / L[r, r], with Y[k, c] = 0 for k < c. Eight threads of one warp share a
// column: each sums every eighth term of row r, three shuffles add the eight
// partial sums, and one thread writes y_r[c]; a warp holds four columns and
// walks their rows in step (lanes before their column's first row add
// nothing), so no block barrier is needed after the loads.
__global__ void __launch_bounds__(kTileThreads)
tri_inv_tile_kernel(const float* __restrict__ l, int ldl,
                    float* __restrict__ y, int bs) {
  extern __shared__ float smem[];
  const int ldy = bs + 1;
  float* L = smem;                 // bs x bs, zeros above the diagonal
  float* Y = smem + bs * bs;       // bs x (bs + 1)
  float* dinv = Y + bs * ldy;      // 1 / L[r, r]
  const int tid = threadIdx.x;
  const int c = tid / kParts, t = tid % kParts;
  const int c_first = (tid / 32) * (32 / kParts);  // the warp's first column

  for (int e = tid; e < bs * bs; e += kTileThreads) {
    const int i = e / bs, k = e - i * bs;
    L[e] = k <= i ? l[(size_t)i * ldl + k] : 0.f;
    Y[i * ldy + k] = 0.f;
  }
  for (int r = tid; r < bs; r += kTileThreads)
    dinv[r] = 1.f / l[(size_t)r * ldl + r];
  __syncthreads();

  if (c_first < bs) {
    for (int r = c_first; r < bs; ++r) {
      float s = 0.f;
      if (c < bs && r >= c) {
        // four partial sums over k = c + t, c + t + 8, ... break the chain
        const float* Lr = L + r * bs;
        float s1 = 0.f, s2 = 0.f, s3 = 0.f;
        int k = c + t;
        for (; k + 3 * kParts < r; k += 4 * kParts) {
          s += Lr[k] * Y[k * ldy + c];
          s1 += Lr[k + kParts] * Y[(k + kParts) * ldy + c];
          s2 += Lr[k + 2 * kParts] * Y[(k + 2 * kParts) * ldy + c];
          s3 += Lr[k + 3 * kParts] * Y[(k + 3 * kParts) * ldy + c];
        }
        for (; k < r; k += kParts) s += Lr[k] * Y[k * ldy + c];
        s = (s + s1) + (s2 + s3);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (t == 0 && c < bs && r >= c)
        Y[r * ldy + c] = ((r == c ? 1.f : 0.f) - s) * dinv[r];
      __syncwarp();
    }
  }
  __syncthreads();
  for (int e = tid; e < bs * bs; e += kTileThreads) {
    const int i = e / bs, k = e - i * bs;
    y[e] = Y[i * ldy + k];
  }
}

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kMMThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

// out = beta * c + alpha * a b^T for a (M, K), b (N, K), c and out (M, N),
// each with its own row stride and unit column stride. `out` may be `c`
// itself (each element is read and written by one thread), but must not
// overlap a or b. beta * c is always formed, so beta = 0 still gives 0 * c.
__global__ void __launch_bounds__(kMMThreads)
matmul_nt_kernel(const float* __restrict__ a, int lda,
                 const float* __restrict__ b, int ldb, const float* c,
                 int ldc, float* out, int ldo, int M, int N, int K,
                 float alpha, float beta) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Bs[kBK][kBN + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.y * kBM, c0 = blockIdx.x * kBN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // both operands are K-contiguous: 16 neighbouring threads read 16
    // neighbouring floats of one row
    for (int e = tid; e < kBM * kBK; e += kMMThreads) {
      const int m = e / kBK, kk = e - m * kBK;
      const int r = r0 + m, k = k0 + kk;
      As[kk][m] = (r < M && k < K) ? a[(size_t)r * lda + k] : 0.f;
      const int n = c0 + m;
      Bs[kk][m] = (n < N && k < K) ? b[(size_t)n * ldb + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) av[p] = As[kk][ty + 16 * p];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = Bs[kk][tx + 16 * q];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] += av[p] * bv[q];
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = r0 + ty + 16 * p;
    if (r >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = c0 + tx + 16 * q;
      if (col < N)
        out[(size_t)r * ldo + col] =
            beta * c[(size_t)r * ldc + col] + alpha * acc[p][q];
    }
  }
}

// Opt in to more than 48 KB of dynamic shared memory where needed.
template <typename Kernel>
bool set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return true;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  return cudaPeekAtLastError() == cudaSuccess;
}

}  // namespace

void launch_chol_tile(const float* a, int lda, float* l, int bs,
                      cudaStream_t stream) {
  const size_t smem = ((size_t)bs * (bs + 1) + kPanel) * sizeof(float);
  if (!set_smem(chol_tile_kernel, smem)) return;
  chol_tile_kernel<<<1, kTileThreads, smem, stream>>>(a, lda, l, bs);
}

void launch_tri_inv_tile(const float* l, int ldl, float* y, int bs,
                         cudaStream_t stream) {
  const size_t smem = ((size_t)bs * bs + (size_t)bs * (bs + 1) + bs) *
                      sizeof(float);
  if (!set_smem(tri_inv_tile_kernel, smem)) return;
  tri_inv_tile_kernel<<<1, kTileThreads, smem, stream>>>(l, ldl, y, bs);
}

void launch_matmul_nt(const float* a, int lda, const float* b, int ldb,
                      const float* c, int ldc, float* out, int ldo, int M,
                      int N, int K, float alpha, float beta,
                      cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  matmul_nt_kernel<<<grid, kMMThreads, 0, stream>>>(
      a, lda, b, ldb, c, ldc, out, ldo, M, N, K, alpha, beta);
}
