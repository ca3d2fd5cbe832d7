// Flash attention forward: online-softmax attention over a grouped-query
// layout, q (B, Hq, Sq, D) and k/v (B, Hkv, Skv, D), query head h reading
// key/value head h / (Hq / Hkv).
//
// Replaces: repro/kernels/flash_attention.py `flash_attention` (pallas_call
// at :91, body `_flash_kernel` :31), reached through repro/kernels/ops.py
// `attention` (:49), which repeated the kv heads and padded both sequences
// to block multiples first. Here the block maps its head to the kv head and
// masks ragged rows and keys itself, so no copy is made.
//
// The function is the Pallas kernel's: s = q.k^T * scale in float32, keys
// at or past kv_end and (causal) keys past the query's position set to
// -1e30 (never -inf: a tile with every key masked then gives exp(0) terms,
// not NaN, and a row that already saw a valid key gives them weight 0),
// running max m, sum l and accumulator in float32, the output acc / max(l,
// 1e-30) written in the input's dtype.
//
// What bounds it on this card: per (query, key) pair 4 D flops against
// 2 D input bytes once per query tile, so at the model's lengths (S = 4,096,
// D = 128) it is far above the line between memory and the tensor cores:
// the bound is operations, 2.75e11 causal flops per qwen3-1.7b prefill
// layer, 0.28 ms at the bf16 tensor-core peak (4.1 ms at the CUDA cores'
// fp32 peak).
//
// Three kernels:
//   * bfloat16 at D = 64 and 128 (the served models' head dims):
//     flash_attention_sm90.cu, TMA ring + wgmma + warp specialization.
//   * bfloat16 at D = 16 and 32, this file: one block per (tile of 64
//     queries, q head, batch) walking the key/value tiles of 64 in order (up
//     to the diagonal when causal), query tiles issued last-first, so the
//     long causal rows start first; four warps of 16 query rows on the
//     tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). Q stays
//     in registers as A fragments; the K and V tiles are staged in shared
//     memory (rows padded by 16 bytes, so fragment loads hit distinct
//     banks), K read as B fragments with 32-bit loads, V with
//     ldmatrix.trans. The score accumulators become P's A fragments in
//     registers. P is not rounded to bf16 as a whole: it enters the tensor
//     cores as a bf16 high part plus a bf16 remainder (two products), so it
//     keeps 16 significant bits, within 2^-17 of the float32 P that the
//     Pallas kernel multiplies. Synchronous single-buffered loads: these
//     head dims serve no model of the repo.
//   * float32: CUDA cores only (no TF32), 256 threads; Q, K, V and P tiles
//     in shared memory as float32; each thread computes a 4 x 4 block of
//     scores and a 4 x D/16 block of the output, with float4 loads.
#include <cuda_bf16.h>

#include <cstdint>

#include "flash_common.cuh"
#include "kernels.h"

namespace {

using flash::kMinL;
using flash::kNegInf;
using flash::ldmatrix_x4_trans;
using flash::mma_bf16;
using flash::split_bf16;
constexpr int kBQ = 64;            // queries a block
constexpr int kBK = 64;            // keys a tile

// ---- float32, CUDA cores ---------------------------------------------------

constexpr int kSimtThreads = 256;  // 16 x 16: ty picks rows, tx keys/columns

template <int D>
constexpr size_t simt_smem() {
  return sizeof(float) * (kBQ * (D + 4) + 2 * kBK * (D + 4) + kBQ * (kBK + 4));
}

// Output column of a thread's c-th accumulator: float4 groups of 64
// columns when a thread holds at least four, else a contiguous run.
template <int D>
__device__ __forceinline__ int simt_col(int tx, int c) {
  constexpr int NC = D / 16;
  if constexpr (NC >= 4)
    return (c >> 2) * 64 + tx * 4 + (c & 3);
  else
    return tx * NC + c;
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
flash_simt_kernel(FlashParams p) {
  constexpr int LD = D + 4;    // row stride of the Q, K, V tiles (floats)
  constexpr int LP = kBK + 4;  // row stride of the P tile
  constexpr int NC = D / 16;   // output columns a thread holds
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.Hq / p.Hkv);
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBQ * D; i += kSimtThreads) {
    const int r = i / D, c = i % D;
    Qs[r * LD + c] = q0 + r < p.Sq ? q[(long long)(q0 + r) * p.q_ss + c] : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int kv_stop = p.causal ? min(p.kv_end, q0 + kBQ) : p.kv_end;
  for (int k0 = 0; k0 < kv_stop; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kSimtThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.Skv;
      Ks[r * LD + c] = in ? k[(long long)(k0 + r) * p.k_ss + c] : 0.f;
      Vs[r * LD + c] = in ? v[(long long)(k0 + r) * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i and keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // mask, online softmax; a row's 64 keys lie on the 16 lanes of a
    // half-warp, so its max is reduced with shuffles inside it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < p.kv_end && (!p.causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        rs += e;
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = e;
      }
      l[i] = l[i] * alpha + rs;  // this thread's share; summed at the end
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V over the tile's keys, four at a time
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * LP + kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = &Vs[(kk + e) * LD];
        float vb[NC];
        if constexpr (NC >= 4) {
#pragma unroll
          for (int c4 = 0; c4 < NC / 4; ++c4) {
            const float4 t =
                *reinterpret_cast<const float4*>(&vrow[c4 * 64 + tx * 4]);
            vb[4 * c4] = t.x;
            vb[4 * c4 + 1] = t.y;
            vb[4 * c4 + 2] = t.z;
            vb[4 * c4 + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < NC; ++c) vb[c] = vrow[tx * NC + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe = e == 0 ? pa[i].x : e == 1 ? pa[i].y
                         : e == 2 ? pa[i].z : pa[i].w;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pe, vb[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = fmaxf(lt, kMinL);
    const int qpos = q0 + ty + 16 * i;
    if (qpos < p.Sq) {
      float* orow = o + (long long)qpos * p.o_ss;
#pragma unroll
      for (int c = 0; c < NC; ++c) orow[simt_col<D>(tx, c)] = acc[i][c] / lt;
    }
  }
}

// ---- bfloat16, tensor cores -------------------------------------------------

constexpr int kMmaThreads = 128;  // four warps of 16 query rows

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_mma_kernel(FlashParams p) {
  constexpr int LDS = D + 8;  // shared row stride (bf16): 16 bytes of pad
  constexpr int KD = D / 16;  // k-steps of q.k^T
  constexpr int ND = D / 8;   // n-tiles of the output
  constexpr int NK = kBK / 8; // n-tiles of the scores
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK * LDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.Hq / p.Hkv);
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two rows

  // Q's A fragments, straight from device memory (rows past Sq are zeros)
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = f & 1 ? r1 : r0, col = 16 * kk + 8 * (f >> 1) + 2 * t;
      qa[kk][f] = row < p.Sq ? *reinterpret_cast<const uint32_t*>(
                                   q + (long long)row * p.q_ss + col)
                             : 0u;
    }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int f = 0; f < 4; ++f) acc[n][f] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int kv_stop = p.causal ? min(p.kv_end, q0 + kBQ) : p.kv_end;
  for (int k0 = 0; k0 < kv_stop; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * CPR; i += kMmaThreads) {
      const int r = i / CPR, c = (i % CPR) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < p.Skv) {
        kv = *reinterpret_cast<const uint4*>(k + (long long)(k0 + r) * p.k_ss + c);
        vv = *reinterpret_cast<const uint4*>(v + (long long)(k0 + r) * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r * LDS + c]) = kv;
      *reinterpret_cast<uint4*>(&Vs[r * LDS + c]) = vv;
    }
    __syncthreads();

    // s = q k^T for this warp's 16 rows and the tile's 64 keys
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int f = 0; f < 4; ++f) s[j][f] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const __nv_bfloat16* kp = &Ks[(8 * j + g) * LDS + 16 * kk + 2 * t];
        mma_bf16(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // mask and online softmax; a row's keys lie on the four lanes of its
    // group g, so its max and sum are reduced with two shuffles
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * j + 2 * t + e;
        const bool in = kpos < p.kv_end;
        const bool ok0 = in && (!p.causal || kpos <= r0);
        const bool ok1 = in && (!p.causal || kpos <= r1);
        s[j][e] = ok0 ? s[j][e] * p.scale : kNegInf;
        s[j][2 + e] = ok1 ? s[j][2 + e] * p.scale : kNegInf;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * a0 + rs0;  // this thread's share; summed at the end
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }

    // acc += P V, 16 keys at a time: the score tiles 2 kk and 2 kk + 1 are
    // P's A fragment for those keys, as a high and a low bf16 part
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      const int mi = lane >> 3;
      const __nv_bfloat16* vrow =
          &Vs[(16 * kk + (mi & 1) * 8 + (lane & 7)) * LDS + 8 * (mi >> 1)];
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vb[4];  // B fragments of output tiles n and n + 1
        ldmatrix_x4_trans(vb, vrow + 8 * n);
        mma_bf16(acc[n], ph, vb[0], vb[1]);
        mma_bf16(acc[n], pl, vb[0], vb[1]);
        mma_bf16(acc[n + 1], ph, vb[2], vb[3]);
        mma_bf16(acc[n + 1], pl, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, kMinL), inv1 = 1.f / fmaxf(l1, kMinL);
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = 8 * n + 2 * t;
    if (r0 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)r0 * p.o_ss + col) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)r1 * p.o_ss + col) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int D>
void run_simt(const FlashParams& p, dim3 grid, cudaStream_t stream) {
  constexpr size_t smem = simt_smem<D>();
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(flash_simt_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    if (cudaPeekAtLastError() != cudaSuccess) return;
  }
  flash_simt_kernel<D><<<grid, kSimtThreads, smem, stream>>>(p);
}

template <int D>
void run_mma(const FlashParams& p, dim3 grid, cudaStream_t stream) {
  flash_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(p);
}

}  // namespace

const char* launch_flash_attention(const FlashParams& p, bool bf16,
                                   cudaStream_t stream) {
  if (bf16 && p.D >= 64) return launch_flash_wgmma(p, stream);
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.Hq, p.B);
  switch (p.D) {
    case 16: bf16 ? run_mma<16>(p, grid, stream) : run_simt<16>(p, grid, stream); break;
    case 32: bf16 ? run_mma<32>(p, grid, stream) : run_simt<32>(p, grid, stream); break;
    case 64: run_simt<64>(p, grid, stream); break;
    case 128: run_simt<128>(p, grid, stream); break;
    default: break;  // the binding accepts 16, 32, 64 and 128 only
  }
  return nullptr;
}
