// Flash attention backward, the first design: dQ, dK and dV of the
// forward's function (flash_attention.cu) from dO, for causal attention over
// a grouped-query layout with as many keys as queries, q (B, Hq, S, D) and
// k/v (B, Hkv, S, D), query head h reading key/value head h / (Hq / Hkv).
// It runs float32 and bfloat16 at D = 16 and 32, which no model of the repo
// trains with; bfloat16 at D = 64 and 128, the training path, runs the
// Hopper design of flash_attention_bwd_sm90.cu from the forward's stored
// statistics.
//
// Replaces: no Pallas kernel. The reference has no custom_vjp around its
// attention kernel; its model trains through the XLA twin
// (repro/models/layers.py `flash_attention_xla`) under jax.checkpoint, and
// XLA differentiates that twin. This kernel computes the same gradient, of
// the function the forward kernel computes (scores q.k^T * scale in float32,
// keys past the query's position set to -1e30, softmax, P.V), so that the
// training path can launch the forward kernel and still take a gradient.
//
// With P = softmax(s), dP = dO.V^T and D_i = sum_d dO_id O_id (= sum_j P_ij
// dP_ij), the gradient is dV = P^T.dO, dS = P * (dP - D), dQ = scale dS.K,
// dK = scale dS^T.Q. Two launches, no atomics, so every run gives the same
// bits:
//   (a) one block per (query tile of 64, q head, batch): streams K once for
//       the row max and sum (the forward saves no log-sum-exp) and, in
//       bf16, V beside it for D = sum_j P_ij dP_ij in float32 (D from the
//       bf16 output would share one rounding error across the row's dS,
//       which adds up in dQ where dS cancels; in float32 D = sum dO O),
//       writes the row's log-sum-exp L and D to a float32 (B, Hq, S)
//       scratch, then streams K and V again to form P = exp(s - L), dP and
//       dS, and accumulates dQ over the keys up to the diagonal;
//   (b) one block per (key tile of 64, kv head, batch): loops over the Hq /
//       Hkv query heads of its group and the query tiles from the diagonal
//       on, recomputes P from the stored L, and accumulates dV and dK in
//       float32 over all of them, so the group's sum needs no second pass.
// Query tiles are issued last-first in (a) and key tiles first-first in
// (b), so the blocks with the most tiles start first.
//
// What bounds it on this card: per causal (query, key) pair, 10 D flops in
// (a) (s and dP twice, dQ; 8 D in float32, whose D reads O) and 8 D in (b)
// (s, dP, dV, dK), against the forward's 4 D: at llama3.2-1b's training shape (S = 4,096, D = 64) it is
// far above the line between memory and the tensor cores, so the bound is
// operations. Kernels:
//   * bfloat16 at D = 16 and 32: mma.sync m16n8k16 with
//     bf16 operands and float32 accumulators, four warps of 16 rows (query
//     rows in (a), key rows in (b)). In (a) Q and dO stay in registers as A
//     fragments; the K and V tiles are staged in shared memory (rows padded
//     by 16 bytes), read as B fragments with 32-bit loads for s and dP and
//     with ldmatrix.trans for dS.K. In (b) the block's K and V tiles, and
//     for each query tile the Q and dO tiles, sit in shared memory; K and V
//     give the A fragments of s^T = K.Q^T and dP^T = V.dO^T, and P^T and
//     dS^T, rounded to bf16, are the A fragments of P^T.dO and dS^T.Q
//     straight from the accumulators. Synchronous loads: a simple first
//     design.
//   * float32: CUDA cores only (no TF32), 256 threads, every tile in
//     shared memory as float32, each thread a 4 x 4 block of the score
//     tile and a 4 x D/16 block of its outputs. No model of the repo trains
//     in float32 at full size.
#include <cuda_bf16.h>

#include <cstdint>

#include "flash_common.cuh"
#include "kernels.h"

namespace {

using flash::as_u32;
using flash::kNegInf;
using flash::ldmatrix_x4_trans;
using flash::mma_bf16;
using bf16 = __nv_bfloat16;

constexpr int kT = 64;  // queries or keys a tile

// The base of head `h` of batch `b` of a (B, H, S, D) operand.
template <typename T>
__device__ __forceinline__ T* head_ptr(const void* base, int b, int h,
                                       long long sb, long long sh) {
  return static_cast<T*>(const_cast<void*>(base)) + b * sb + h * sh;
}

// ---- bfloat16, tensor cores -------------------------------------------------

constexpr int kMmaThreads = 128;  // four warps of 16 rows

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  return as_u32(__floats2bfloat162_rn(x0, x1));
}

// rows [r0, r0 + kT) of a (S, D) head with row stride `ss` into a shared
// tile of row stride LDS, 16 bytes a thread, rows past S as zeros
template <int D, int LDS>
__device__ __forceinline__ void stage_bf16(bf16* dst, const bf16* src,
                                           long long ss, int r0, int S,
                                           int tid, int nthreads) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  for (int i = tid; i < kT * CPR; i += nthreads) {
    const int r = i / CPR, c = (i % CPR) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      x = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * ss + c);
    *reinterpret_cast<uint4*>(&dst[r * LDS + c]) = x;
  }
}

// c[j] = a . B_j^T for the 8 n-tiles of a 64-row shared tile: a the warp's
// 16 x D A fragments, the tile's row 8 j + g giving column g of n-tile j
template <int D, int LDS>
__device__ __forceinline__ void tile_scores(float (&c)[kT / 8][4],
                                            const uint32_t (&a)[D / 16][4],
                                            const bf16* tile, int g, int t) {
#pragma unroll
  for (int j = 0; j < kT / 8; ++j) {
#pragma unroll
    for (int f = 0; f < 4; ++f) c[j][f] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* bp = &tile[(8 * j + g) * LDS + 16 * kk + 2 * t];
      mma_bf16(c[j], a[kk], ld_u32(bp), ld_u32(bp + 8));
    }
  }
}

// acc += x . tile: x the warp's 16 x 64 accumulators (rounded to bf16 as
// A fragments), the 64 x D shared tile read transposed as B fragments
template <int D, int LDS>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&x)[kT / 8][4],
                                           const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    const int mi = lane >> 3;
    const bf16* row =
        &tile[(16 * kk + (mi & 1) * 8 + (lane & 7)) * LDS + 8 * (mi >> 1)];
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t b[4];  // B fragments of output tiles n and n + 1
      ldmatrix_x4_trans(b, row + 8 * n);
      mma_bf16(acc[n], a, b[0], b[1]);
      mma_bf16(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// (a): the row statistics and dQ of one query tile
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dq_mma_kernel(FlashBwdParams p) {
  constexpr int LDS = D + 8, KD = D / 16, ND = D / 8, NK = kT / 8;
  __shared__ __align__(16) bf16 Ks[kT * LDS];
  __shared__ __align__(16) bf16 Vs[kT * LDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.Hq / p.Hkv);
  const bf16* q = head_ptr<const bf16>(p.q, b, h, p.q_sb, p.q_sh);
  const bf16* k = head_ptr<const bf16>(p.k, b, hk, p.k_sb, p.k_sh);
  const bf16* v = head_ptr<const bf16>(p.v, b, hk, p.v_sb, p.v_sh);
  const bf16* dout = head_ptr<const bf16>(p.dout, b, h, p.do_sb, p.do_sh);
  bf16* dq = head_ptr<bf16>(p.dq, b, h, p.dq_sb, p.dq_sh);
  const long long row_base = ((long long)b * p.Hq + h) * p.S;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows

  // Q's and dO's A fragments
  uint32_t qa[KD][4], da[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = f & 1 ? r1 : r0, col = 16 * kk + 8 * (f >> 1) + 2 * t;
      qa[kk][f] = da[kk][f] = 0u;
      if (row < p.S) {
        qa[kk][f] = ld_u32(q + (long long)row * p.q_ss + col);
        da[kk][f] = ld_u32(dout + (long long)row * p.do_ss + col);
      }
    }

  // pass 1: the row max and sum over the keys up to the diagonal, and D =
  // sum_j P_ij dP_ij in float32 beside the sum (u rescaled as l is). D
  // from the forward's output, sum_d dO O, would read O rounded to bf16:
  // an error in D that every dS of the row shares, so it adds up in dQ
  // where the terms of dS cancel
  const int kv_stop = min(p.S, q0 + kT);
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f, u0 = 0.f, u1 = 0.f;
  for (int k0 = 0; k0 < kv_stop; k0 += kT) {
    __syncthreads();  // the previous tile's readers are done
    stage_bf16<D, LDS>(Ks, k, p.k_ss, k0, p.S, tid, kMmaThreads);
    stage_bf16<D, LDS>(Vs, v, p.v_ss, k0, p.S, tid, kMmaThreads);
    __syncthreads();
    float s[NK][4], dp[NK][4];
    tile_scores<D, LDS>(s, qa, Ks, g, t);
    tile_scores<D, LDS>(dp, da, Vs, g, t);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * j + 2 * t + e;
        s[j][e] = kpos <= r0 && kpos < p.S ? s[j][e] * p.scale : kNegInf;
        s[j][2 + e] = kpos <= r1 && kpos < p.S ? s[j][2 + e] * p.scale
                                               : kNegInf;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float rs0 = 0.f, rs1 = 0.f, us0 = 0.f, us1 = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float e0 = expf(s[j][e] - mn0), e1 = expf(s[j][2 + e] - mn1);
        rs0 += e0;
        rs1 += e1;
        us0 += e0 * dp[j][e];
        us1 += e1 * dp[j][2 + e];
      }
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    l0 = l0 * c0 + rs0;  // this thread's share
    l1 = l1 * c1 + rs1;
    u0 = u0 * c0 + us0;
    u1 = u1 * c1 + us1;
    m0 = mn0;
    m1 = mn1;
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    u0 += __shfl_xor_sync(0xffffffffu, u0, off);
    u1 += __shfl_xor_sync(0xffffffffu, u1, off);
  }
  // every row below S sees key 0, so l >= 1
  const float lse0 = m0 + logf(l0), lse1 = m1 + logf(l1);
  const float d0 = u0 / l0, d1 = u1 / l1;
  if (t == 0) {
    if (r0 < p.S) {
      p.lse[row_base + r0] = lse0;
      p.delta[row_base + r0] = d0;
    }
    if (r1 < p.S) {
      p.lse[row_base + r1] = lse1;
      p.delta[row_base + r1] = d1;
    }
  }

  // pass 2: P, dP, dS, and dQ += dS K
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int f = 0; f < 4; ++f) acc[n][f] = 0.f;
  for (int k0 = 0; k0 < kv_stop; k0 += kT) {
    __syncthreads();
    stage_bf16<D, LDS>(Ks, k, p.k_ss, k0, p.S, tid, kMmaThreads);
    stage_bf16<D, LDS>(Vs, v, p.v_ss, k0, p.S, tid, kMmaThreads);
    __syncthreads();
    float s[NK][4], dp[NK][4];
    tile_scores<D, LDS>(s, qa, Ks, g, t);
    tile_scores<D, LDS>(dp, da, Vs, g, t);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * j + 2 * t + e;
        const float p0 = kpos <= r0 && kpos < p.S
                             ? expf(s[j][e] * p.scale - lse0) : 0.f;
        const float p1 = kpos <= r1 && kpos < p.S
                             ? expf(s[j][2 + e] * p.scale - lse1) : 0.f;
        s[j][e] = p0 * (dp[j][e] - d0);  // s now holds dS
        s[j][2 + e] = p1 * (dp[j][2 + e] - d1);
      }
    accumulate<D, LDS>(acc, s, Ks, lane);
  }

#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = 8 * n + 2 * t;
    if (r0 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(dq + (long long)r0 * p.dq_ss + col) =
          __floats2bfloat162_rn(acc[n][0] * p.scale, acc[n][1] * p.scale);
    if (r1 < p.S)
      *reinterpret_cast<__nv_bfloat162*>(dq + (long long)r1 * p.dq_ss + col) =
          __floats2bfloat162_rn(acc[n][2] * p.scale, acc[n][3] * p.scale);
  }
}

template <int D>
constexpr size_t dkdv_mma_smem() {
  return 4 * sizeof(bf16) * kT * (D + 8) + 2 * sizeof(float) * kT;
}

// (b): dK and dV of one key tile, summed over its group's query heads
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
bwd_dkdv_mma_kernel(FlashBwdParams p) {
  constexpr int LDS = D + 8, KD = D / 16, ND = D / 8, NK = kT / 8;
  extern __shared__ uint4 smem_u4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_u4);
  bf16* Vs = Ks + kT * LDS;
  bf16* Qs = Vs + kT * LDS;
  bf16* Ds = Qs + kT * LDS;  // the dO tile
  float* Ls = reinterpret_cast<float*>(Ds + kT * LDS);
  float* Dl = Ls + kT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kT;
  const int hk = blockIdx.y, b = blockIdx.z, rep = p.Hq / p.Hkv;
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;  // this thread's keys
  stage_bf16<D, LDS>(Ks, head_ptr<const bf16>(p.k, b, hk, p.k_sb, p.k_sh),
                     p.k_ss, k0, p.S, tid, kMmaThreads);
  stage_bf16<D, LDS>(Vs, head_ptr<const bf16>(p.v, b, hk, p.v_sb, p.v_sh),
                     p.v_ss, k0, p.S, tid, kMmaThreads);

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int f = 0; f < 4; ++f) dk[n][f] = dv[n][f] = 0.f;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const bf16* q = head_ptr<const bf16>(p.q, b, h, p.q_sb, p.q_sh);
    const bf16* dout = head_ptr<const bf16>(p.dout, b, h, p.do_sb, p.do_sh);
    const long long row_base = ((long long)b * p.Hq + h) * p.S;
    for (int q0 = k0; q0 < p.S; q0 += kT) {
      __syncthreads();  // the previous tile's readers are done
      stage_bf16<D, LDS>(Qs, q, p.q_ss, q0, p.S, tid, kMmaThreads);
      stage_bf16<D, LDS>(Ds, dout, p.do_ss, q0, p.S, tid, kMmaThreads);
      if (tid < kT) {
        const bool in = q0 + tid < p.S;
        Ls[tid] = in ? p.lse[row_base + q0 + tid] : 0.f;
        Dl[tid] = in ? p.delta[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();

      // s^T = K Q^T and dP^T = V dO^T for this warp's 16 keys
      uint32_t ka[KD][4], va[KD][4];
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int off = (warp * 16 + g + 8 * (f & 1)) * LDS + 16 * kk +
                          8 * (f >> 1) + 2 * t;
          ka[kk][f] = ld_u32(Ks + off);
          va[kk][f] = ld_u32(Vs + off);
        }
      float s[NK][4], dp[NK][4];
      tile_scores<D, LDS>(s, ka, Qs, g, t);
      tile_scores<D, LDS>(dp, va, Ds, g, t);
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e, qpos = q0 + c;
          const bool in = qpos < p.S;
          const float p0 = in && qpos >= kr0
                               ? expf(s[j][e] * p.scale - Ls[c]) : 0.f;
          const float p1 = in && qpos >= kr1
                               ? expf(s[j][2 + e] * p.scale - Ls[c]) : 0.f;
          s[j][e] = p0;
          s[j][2 + e] = p1;
          dp[j][e] = p0 * (dp[j][e] - Dl[c]);  // dp now holds dS^T
          dp[j][2 + e] = p1 * (dp[j][2 + e] - Dl[c]);
        }
      accumulate<D, LDS>(dv, s, Ds, lane);
      accumulate<D, LDS>(dk, dp, Qs, lane);
    }
  }

  bf16* dkp = head_ptr<bf16>(p.dk, b, hk, p.dk_sb, p.dk_sh);
  bf16* dvp = head_ptr<bf16>(p.dv, b, hk, p.dv_sb, p.dv_sh);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = 8 * n + 2 * t;
    if (kr0 < p.S) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + (long long)kr0 * p.dk_ss +
                                         col) =
          __floats2bfloat162_rn(dk[n][0] * p.scale, dk[n][1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + (long long)kr0 * p.dv_ss +
                                         col) =
          __floats2bfloat162_rn(dv[n][0], dv[n][1]);
    }
    if (kr1 < p.S) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + (long long)kr1 * p.dk_ss +
                                         col) =
          __floats2bfloat162_rn(dk[n][2] * p.scale, dk[n][3] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + (long long)kr1 * p.dv_ss +
                                         col) =
          __floats2bfloat162_rn(dv[n][2], dv[n][3]);
    }
  }
}

// ---- float32, CUDA cores ---------------------------------------------------

constexpr int kSimtThreads = 256;  // 16 x 16: ty picks rows, tx columns

// rows [r0, r0 + kT) of a (S, D) float32 head into a shared tile of row
// stride LD, rows past S as zeros
template <int D, int LD>
__device__ __forceinline__ void stage_f32(float* dst, const float* src,
                                          long long ss, int r0, int S,
                                          int tid) {
  for (int i = tid; i < kT * D; i += kSimtThreads) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = r0 + r < S ? src[(long long)(r0 + r) * ss + c] : 0.f;
  }
}

// x[i][j] = row (ty + 16 i) of A . row (tx + 16 j) of B, over D
template <int D, int LD>
__device__ __forceinline__ void simt_scores(float (&x)[4][4], const float* A,
                                            const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * LD + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bb[j] = *reinterpret_cast<const float4*>(&B[(tx + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[i][j] = fmaf(a[i].x, bb[j].x, x[i][j]);
        x[i][j] = fmaf(a[i].y, bb[j].y, x[i][j]);
        x[i][j] = fmaf(a[i].z, bb[j].z, x[i][j]);
        x[i][j] = fmaf(a[i].w, bb[j].w, x[i][j]);
      }
  }
}

// acc[i][c] += sum_r X[ty + 16 i][r] * T[r][tx + 16 c] over the tile's 64
// rows r
template <int D, int LD, int LP>
__device__ __forceinline__ void simt_accumulate(float (&acc)[4][D / 16],
                                                const float* X,
                                                const float* T, int ty,
                                                int tx) {
#pragma unroll 4
  for (int r = 0; r < kT; ++r) {
    float tv[D / 16];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) tv[c] = T[r * LD + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xv = X[(ty + 16 * i) * LP + r];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] = fmaf(xv, tv[c], acc[i][c]);
    }
  }
}

template <int D>
constexpr size_t dq_simt_smem() {
  return sizeof(float) * (4 * kT * (D + 4) + kT * (kT + 4));
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
bwd_dq_simt_kernel(FlashBwdParams p) {
  constexpr int LD = D + 4, LP = kT + 4, NC = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ds = Qs + kT * LD;  // the dO tile
  float* Ks = Ds + kT * LD;
  float* Vs = Ks + kT * LD;
  float* Ps = Vs + kT * LD;  // dS

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.Hq / p.Hkv);
  const float* k = head_ptr<const float>(p.k, b, hk, p.k_sb, p.k_sh);
  const float* v = head_ptr<const float>(p.v, b, hk, p.v_sb, p.v_sh);
  const float* o = head_ptr<const float>(p.o, b, h, p.o_sb, p.o_sh);
  float* dq = head_ptr<float>(p.dq, b, h, p.dq_sb, p.dq_sh);
  const long long row_base = ((long long)b * p.Hq + h) * p.S;
  stage_f32<D, LD>(Qs, head_ptr<const float>(p.q, b, h, p.q_sb, p.q_sh),
                   p.q_ss, q0, p.S, tid);
  stage_f32<D, LD>(Ds, head_ptr<const float>(p.dout, b, h, p.do_sb,
                                             p.do_sh),
                   p.do_ss, q0, p.S, tid);
  __syncthreads();

  // D of rows ty + 16 i, reduced over the half-warp of its 16 lanes
  float dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    float acc = 0.f;
    if (row < p.S)
      for (int c = tx; c < D; c += 16)
        acc += Ds[(ty + 16 * i) * LD + c] * o[(long long)row * p.o_ss + c];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    dl[i] = acc;
  }

  // pass 1: row max and sum
  const int kv_stop = min(p.S, q0 + kT);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < kv_stop; k0 += kT) {
    __syncthreads();
    stage_f32<D, LD>(Ks, k, p.k_ss, k0, p.S, tid);
    __syncthreads();
    float s[4][4];
    simt_scores<D, LD>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = kpos <= qpos && kpos < p.S ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += expf(s[i][j] - mn);
      l[i] = l[i] * expf(m[i] - mn) + rs;  // this thread's share
      m[i] = mn;
    }
  }
  float lse[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lse[i] = m[i] + logf(lt);
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < p.S) {
      p.lse[row_base + row] = lse[i];
      p.delta[row_base + row] = dl[i];
    }
  }

  // pass 2: dS into shared memory, then dQ += dS K
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < kv_stop; k0 += kT) {
    __syncthreads();
    stage_f32<D, LD>(Ks, k, p.k_ss, k0, p.S, tid);
    stage_f32<D, LD>(Vs, v, p.v_ss, k0, p.S, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    simt_scores<D, LD>(s, Qs, Ks, ty, tx);
    simt_scores<D, LD>(dp, Ds, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float pij = kpos <= qpos && kpos < p.S
                              ? expf(s[i][j] * p.scale - lse[i]) : 0.f;
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = pij * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();
    simt_accumulate<D, LD, LP>(acc, Ps, Ks, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < p.S)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        dq[(long long)row * p.dq_ss + tx + 16 * c] = acc[i][c] * p.scale;
  }
}

template <int D>
constexpr size_t dkdv_simt_smem() {
  return sizeof(float) * (4 * kT * (D + 4) + 2 * kT * (kT + 4) + 2 * kT);
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
bwd_dkdv_simt_kernel(FlashBwdParams p) {
  constexpr int LD = D + 4, LP = kT + 4, NC = D / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kT * LD;
  float* Qs = Vs + kT * LD;
  float* Ds = Qs + kT * LD;  // the dO tile
  float* Ps = Ds + kT * LD;  // P^T
  float* Ss = Ps + kT * LP;  // dS^T
  float* Ls = Ss + kT * LP;
  float* Dl = Ls + kT;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * kT;
  const int hk = blockIdx.y, b = blockIdx.z, rep = p.Hq / p.Hkv;
  stage_f32<D, LD>(Ks, head_ptr<const float>(p.k, b, hk, p.k_sb, p.k_sh),
                   p.k_ss, k0, p.S, tid);
  stage_f32<D, LD>(Vs, head_ptr<const float>(p.v, b, hk, p.v_sb, p.v_sh),
                   p.v_ss, k0, p.S, tid);

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const long long row_base = ((long long)b * p.Hq + h) * p.S;
    for (int q0 = k0; q0 < p.S; q0 += kT) {
      __syncthreads();
      stage_f32<D, LD>(Qs, head_ptr<const float>(p.q, b, h, p.q_sb, p.q_sh),
                       p.q_ss, q0, p.S, tid);
      stage_f32<D, LD>(Ds, head_ptr<const float>(p.dout, b, h, p.do_sb,
                                                 p.do_sh),
                       p.do_ss, q0, p.S, tid);
      if (tid < kT) {
        const bool in = q0 + tid < p.S;
        Ls[tid] = in ? p.lse[row_base + q0 + tid] : 0.f;
        Dl[tid] = in ? p.delta[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();
      // keys ty + 16 i, queries tx + 16 j
      float s[4][4], dp[4][4];
      simt_scores<D, LD>(s, Ks, Qs, ty, tx);
      simt_scores<D, LD>(dp, Vs, Ds, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, qpos = q0 + c;
          const float pij = qpos >= kpos && qpos < p.S
                                ? expf(s[i][j] * p.scale - Ls[c]) : 0.f;
          Ps[(ty + 16 * i) * LP + c] = pij;
          Ss[(ty + 16 * i) * LP + c] = pij * (dp[i][j] - Dl[c]);
        }
      }
      __syncthreads();
      simt_accumulate<D, LD, LP>(dv, Ps, Ds, ty, tx);
      simt_accumulate<D, LD, LP>(dk, Ss, Qs, ty, tx);
    }
  }

  float* dkp = head_ptr<float>(p.dk, b, hk, p.dk_sb, p.dk_sh);
  float* dvp = head_ptr<float>(p.dv, b, hk, p.dv_sb, p.dv_sh);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row < p.S)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dkp[(long long)row * p.dk_ss + tx + 16 * c] = dk[i][c] * p.scale;
        dvp[(long long)row * p.dv_ss + tx + 16 * c] = dv[i][c];
      }
  }
}

// Raise a kernel's dynamic shared-memory limit to `smem` where it exceeds
// the default 48 KB; false if the card refused.
template <typename K>
bool allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return true;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  return cudaPeekAtLastError() == cudaSuccess;
}

template <int D>
void run_mma(const FlashBwdParams& p, cudaStream_t stream) {
  const int tiles = (p.S + kT - 1) / kT;
  bwd_dq_mma_kernel<D><<<dim3(tiles, p.Hq, p.B), kMmaThreads, 0, stream>>>(p);
  if (cudaPeekAtLastError() != cudaSuccess) return;
  constexpr size_t smem = dkdv_mma_smem<D>();
  if (!allow_smem(bwd_dkdv_mma_kernel<D>, smem)) return;
  bwd_dkdv_mma_kernel<D>
      <<<dim3(tiles, p.Hkv, p.B), kMmaThreads, smem, stream>>>(p);
}

template <int D>
void run_simt(const FlashBwdParams& p, cudaStream_t stream) {
  const int tiles = (p.S + kT - 1) / kT;
  constexpr size_t smem_a = dq_simt_smem<D>(), smem_b = dkdv_simt_smem<D>();
  if (!allow_smem(bwd_dq_simt_kernel<D>, smem_a)) return;
  bwd_dq_simt_kernel<D>
      <<<dim3(tiles, p.Hq, p.B), kSimtThreads, smem_a, stream>>>(p);
  if (cudaPeekAtLastError() != cudaSuccess) return;
  if (!allow_smem(bwd_dkdv_simt_kernel<D>, smem_b)) return;
  bwd_dkdv_simt_kernel<D>
      <<<dim3(tiles, p.Hkv, p.B), kSimtThreads, smem_b, stream>>>(p);
}

template <int D>
void info_of_mma(int out[8]) {
  cudaFuncAttributes a{}, b{};
  cudaFuncGetAttributes(&a, bwd_dq_mma_kernel<D>);
  cudaFuncGetAttributes(&b, bwd_dkdv_mma_kernel<D>);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = kMmaThreads;
  out[4] = b.numRegs;
  out[5] = static_cast<int>(dkdv_mma_smem<D>());
  out[6] = static_cast<int>(b.localSizeBytes);
  out[7] = kMmaThreads;
}

template <int D>
void info_of_simt(int out[8]) {
  cudaFuncAttributes a{}, b{};
  cudaFuncGetAttributes(&a, bwd_dq_simt_kernel<D>);
  cudaFuncGetAttributes(&b, bwd_dkdv_simt_kernel<D>);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes + dq_simt_smem<D>());
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = kSimtThreads;
  out[4] = b.numRegs;
  out[5] = static_cast<int>(dkdv_simt_smem<D>());
  out[6] = static_cast<int>(b.localSizeBytes);
  out[7] = kSimtThreads;
}

}  // namespace

void launch_flash_attention_bwd(const FlashBwdParams& p, bool bf16_kernels,
                                cudaStream_t stream) {
  // the binding accepts bf16 at 16 and 32 only, float32 at 16, 32, 64, 128
  if (bf16_kernels) {
    if (p.D == 16)
      run_mma<16>(p, stream);
    else
      run_mma<32>(p, stream);
    return;
  }
  switch (p.D) {
    case 16: run_simt<16>(p, stream); break;
    case 32: run_simt<32>(p, stream); break;
    case 64: run_simt<64>(p, stream); break;
    default: run_simt<128>(p, stream); break;
  }
}

void flash_attention_bwd_info(int D, bool bf16_kernels, int out[8]) {
  if (bf16_kernels) {
    D == 16 ? info_of_mma<16>(out) : info_of_mma<32>(out);
    return;
  }
  switch (D) {
    case 16: info_of_simt<16>(out); break;
    case 32: info_of_simt<32>(out); break;
    case 64: info_of_simt<64>(out); break;
    default: info_of_simt<128>(out); break;
  }
}
