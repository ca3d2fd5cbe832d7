// Flash attention backward in bfloat16 for Hopper (sm_90a), head dims 64
// and 128: dQ, dK and dV of the causal grouped-query attention with as many
// keys as queries, from the forward's stored statistics, on wgmma fed by a
// TMA ring, with no atomics.
//
// Replaces: no Pallas kernel. The reference differentiates its XLA twin of
// the attention kernel (repro/models/layers.py `flash_attention_xla`, :108);
// the port's training launches the forward kernel, so this is that
// kernel's gradient (the first design, flash_attention_bwd.cu, keeps
// float32 and D = 16 / 32).
//
// With P = softmax(s) = exp(s - L), L the row's log-sum-exp that the
// forward stored (flash_attention_sm90.cu), dP = dO V^T and D_i = sum_d
// dO_id O_id, the gradient is dV = P^T dO, dS = P * (dP - D), dQ = scale
// dS K, dK = scale dS^T Q. D reads O at float32 precision: the forward also
// stored its output's bf16 remainder o_lo, and D = sum dO (o + o_lo); D from
// the bf16 output alone shares one rounding error across a row's dS, which
// adds up in dQ where the terms of dS cancel.
//
// What bounds it: operations. Per causal (query, key) pair the gradient
// needs 10 D flops (s, dP, dV, dK, dQ); this design recomputes s and dP
// for dQ, 14 D: at llama3.2-1b's training step (B 4, Hq 32, S 4,096, D 64)
// 9.6e11 flops, 0.97 ms at the 989 TFLOP/s bf16 tensor-core peak (0.69 ms
// at 10 D), against 0.34 GB of operands read once and gradients written
// once. Beside the products, each pair takes two exponentials (one in
// each launch) on the 16-a-clock MUFU units, about half the tensor cores'
// time, which the design hides under the products.
//
// Two launches, each a block of 384 threads: warpgroup 0 the producer (one
// thread keeps TMA loads in flight through a ring of 4 stages, each stage
// completing on a "full" mbarrier and freed by an "empty" one that lane 0
// of each consumer warp arrives on), warpgroups 1 and 2 the consumers
// (setmaxnreg 240 / 24), operands read in place through 4-D tensor maps
// over the model's head-transposed views, tiles in 128-byte-swizzled
// shared memory:
//   (a) dQ: a block per (128 queries, q head, batch), 64 rows a consumer
//       warpgroup, query tiles last-first across all heads (the longest
//       causal rows start first, so no long block is left for the tail).
//       Each row first forms its D from dO, o and o_lo (plain loads, a
//       quarter of the row a lane) and stores it for (b); Q and dO load
//       once; K and V tiles (128 keys at D = 64, 64 at D = 128) stream
//       up to the diagonal. Per tile: S = Q K^T and dP = dO V^T
//       (wgmma, both K-major in shared memory), P = exp2(S scale log2 e -
//       L log2 e), dS = P (dP - D) rounded to bf16 as A fragments in
//       registers, dQ += dS K (wgmma, K MN-major). Two overlaps hide the
//       exponentials: inside a warpgroup, tile n's S and dP are issued
//       before tile n - 1's dQ product, which runs under tile n's
//       exponentials (dS's fragments are rewritten once it retires); and
//       the two warpgroups ping-pong on named barriers, each issuing its
//       products after the other has issued its own.
//   (b) dK and dV: a block per (128 keys, kv head, batch), 64 keys a
//       consumer warpgroup, key tiles first-first across all heads. K and
//       V load once; the ring streams, for each query head of the kv
//       head's group and each query tile of 64 from the diagonal on, Q, dO
//       and the tile's L and D (1-D bulk copies). Per tile: S^T = K Q^T
//       and dP^T = V dO^T, P^T and dS^T as A fragments, dV += P^T dO and
//       dK += dS^T Q (Q and dO read K-major for the first products and
//       MN-major for these). The whole group accumulates in float32
//       registers, so GQA needs no atomics. At D = 64, K's and V's A
//       fragments stay in registers (the first products read only Q and
//       dO from shared memory), with the overlaps of (a); at D = 128 the
//       accumulators take 128 registers a thread, and neither overlap
//       paid there.
// Every output element is written once by one block from sums in a fixed
// order: every run gives the same bits.
//
// Masks only on tiles that cross the causal diagonal of a warpgroup's rows
// or reach past S; TMA fills rows past S with zeros. L and D are read
// (padded to 128 rows) where rows past S meet masked columns only.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_common.cuh"
#include "flash_sm90.cuh"
#include "kernels.h"

namespace {

using flash::as_u32;
using sm90::bulk_load;
using sm90::encode_operand;
using sm90::ex2;
using sm90::kBox;
using sm90::kLog2e;
using sm90::kRow;
using sm90::load_a_fragment;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::reg_fence;
using sm90::smem_addr;
using sm90::sw128_desc;
using sm90::tma_load;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_rs;
using sm90::wgmma_rs_k;
using sm90::wgmma_ss;
using sm90::wgmma_wait;
using bf16 = __nv_bfloat16;

constexpr int kBM = 128;       // rows a block: two consumer warpgroups
constexpr int kThreads = 384;  // producer + two consumer warpgroups

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  return as_u32(__floats2bfloat162_rn(x0, x1));
}

// Ping-pong between the two consumer warpgroups on named barriers 1 and 2
// (the forward's order, FlashAttention-3's): a warpgroup issues its
// products only after the other has issued its own, so one's exponentials
// run under the other's products. Warpgroup 0 issues first; warpgroup 1
// hands over the first turn and skips its last hand-off, so no arrival is
// left over at exit. Both warpgroups issue equally often.
template <bool PP>
__device__ __forceinline__ void wait_turn(int cw) {
  if (!PP) return;
  if (cw == 0)
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 256;\n" ::: "memory");
}

template <bool PP>
__device__ __forceinline__ void pass_turn(int cw) {
  if (!PP) return;
  if (cw == 0)
    asm volatile("bar.arrive 2, 256;\n" ::: "memory");
  else
    asm volatile("bar.arrive 1, 256;\n" ::: "memory");
}

// The A fragments (16 columns each) of a 64 x N accumulator tile x, rounded
// to bf16: accumulator chunks 2 kk and 2 kk + 1 give fragment kk
template <int N>
__device__ __forceinline__ void to_fragments(uint32_t (&a)[N / 16][4],
                                             const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// Stores a 64 x D accumulator tile times `mul` in bf16: this thread's rows
// r0 and r1 = r0 + 8 (those below S) of a (S, D) head with row stride ss
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, long long ss,
                                           const float (&x)[D / 2], float mul,
                                           int r0, int c2, int S) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + c2;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)r0 * ss + col) =
          __floats2bfloat162_rn(x[4 * i] * mul, x[4 * i + 1] * mul);
    if (r0 + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)(r0 + 8) * ss +
                                         col) =
          __floats2bfloat162_rn(x[4 * i + 2] * mul, x[4 * i + 3] * mul);
  }
}

// ---- (a) dQ -----------------------------------------------------------------

template <int D>
struct DqLayout {
  static constexpr int kN = D == 64 ? 128 : 64;   // keys a tile
  static constexpr int kStages = 4;
  static constexpr int kBoxes = D / kBox;         // boxes per row of a tile
  static constexpr int kQBytes = kBM * D * 2;     // Q or dO
  static constexpr int kTileBytes = kN * D * 2;   // one K or V tile
  static constexpr int kBars = 1 + 2 * kStages;   // q/dO, kv[], empty[]
  static constexpr int kSmem =
      2 * kQBytes + 2 * kStages * kTileBytes + 8 * kBars + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    FlashBwdParams p) {
  using L = DqLayout<D>;
  constexpr int S = L::kStages, N = L::kN;
  extern __shared__ uint8_t smem_raw[];
  // Q and dO: kBoxes boxes of [kBM][64] each; each K or V stage: kBoxes
  // boxes of [N][64]; then the barriers
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sdo = sq + L::kQBytes;
  const uint32_t sk = sdo + L::kQBytes;
  const uint32_t sv = sk + S * L::kTileBytes;
  const uint32_t qd_full = sv + S * L::kTileBytes;
  const auto kv_full = [&](int s) { return qd_full + 8 * (1 + s); };
  const auto empty = [&](int s) { return qd_full + 8 * (1 + S + s); };

  const int tid = threadIdx.x, wg = tid >> 7;
  // blocks start in the order of their linear index, x fastest: query
  // tiles on z, last-first, so the longest causal rows of every head start
  // before any shorter ones
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (p.Hq / p.Hkv);
  const int kv_stop = min(p.S, q0 + kBM);
  const int ntiles = (kv_stop + N - 1) / N;

  if (tid == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(kv_full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(qd_full, 2 * L::kQBytes);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load(sq + c * kBM * kRow, &tq, qd_full, c * kBox, q0, h, b);
        tma_load(sdo + c * kBM * kRow, &tdo, qd_full, c * kBox, q0, h, b);
      }
      for (int n = 0; n < ntiles; ++n) {
        const int s = n % S;
        if (n >= S) mbar_wait(empty(s), ((n / S) - 1) & 1);
        const uint32_t ks = sk + s * L::kTileBytes, vs = sv + s * L::kTileBytes;
        mbar_expect_tx(kv_full(s), 2 * L::kTileBytes);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load(ks + c * N * kRow, &tk, kv_full(s), c * kBox, n * N, hk, b);
          tma_load(vs + c * N * kRow, &tv, kv_full(s), c * kBox, n * N, hk, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows 64 cw .. 64 cw + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1, t = tid & 127, lane = t & 31;
    const int g = lane >> 2, c2 = 2 * (lane & 3);  // fragment row, column pair
    const int wq0 = q0 + 64 * cw;                   // the warpgroup's first row
    const int r0 = wq0 + 16 * (t >> 5) + g, r1 = r0 + 8;
    const float sl2 = p.scale * kLog2e;
    const long long row_base = ((long long)b * p.Hq + h) * p.lse_ld;

    // D of a row: sum over d of dO (o + o_lo), a quarter of the row a lane
    // of the row's quad, in float32; 0 past S
    const auto row_delta = [&](int r) {
      float acc = 0.f;
      if (r < p.S) {
        const int c0 = (lane & 3) * (D / 4);
        const bf16* dor = static_cast<const bf16*>(p.dout) + b * p.do_sb +
                          h * p.do_sh + (long long)r * p.do_ss + c0;
        const bf16* orow = static_cast<const bf16*>(p.o) + b * p.o_sb +
                           h * p.o_sh + (long long)r * p.o_ss + c0;
        const bf16* lrow = static_cast<const bf16*>(p.o_lo) + b * p.olo_sb +
                           h * p.olo_sh + (long long)r * p.olo_ss + c0;
#pragma unroll
        for (int i = 0; i < D / 4; i += 8) {
          const uint4 a = *reinterpret_cast<const uint4*>(dor + i);
          const uint4 o = *reinterpret_cast<const uint4*>(orow + i);
          const uint4 l = *reinterpret_cast<const uint4*>(lrow + i);
          const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o);
          const __nv_bfloat162* l2 = reinterpret_cast<const __nv_bfloat162*>(&l);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 af = __bfloat1622float2(a2[j]);
            const float2 of = __bfloat1622float2(o2[j]);
            const float2 lf = __bfloat1622float2(l2[j]);
            acc = fmaf(af.x, of.x + lf.x, acc);
            acc = fmaf(af.y, of.y + lf.y, acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      return acc;
    };
    const float d0 = row_delta(r0), d1 = row_delta(r1);
    if ((lane & 3) == 0) {  // every row of the grid, zeros past S
      p.delta[row_base + r0] = d0;
      p.delta[row_base + r1] = d1;
    }
    // -L log2 e of the two rows, the exponent's offset
    const float nl0 = r0 < p.S ? -p.lse[row_base + r0] * kLog2e : 0.f;
    const float nl1 = r1 < p.S ? -p.lse[row_base + r1] * kLog2e : 0.f;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    float sc[N / 2], dp[N / 2];  // S then dS; dP
    uint32_t dsf[N / 16][4];      // dS's A fragments

    // S = Q K^T and dP = dO V^T of tile n, one commit group: D / 16
    // k-steps of 16 columns, 32 bytes apart inside a 128-byte box row,
    // boxes of 64 columns
    const auto issue_sdp = [&](int n) {
      const uint32_t ks = sk + (n % S) * L::kTileBytes;
      const uint32_t vs = sv + (n % S) * L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a = (kk / 4) * kBM * kRow + cw * 64 * kRow + (kk % 4) * 32;
        const uint32_t bo = (kk / 4) * N * kRow + (kk % 4) * 32;
        wgmma_ss(sc, sw128_desc(sq + a, 16, 1024), sw128_desc(ks + bo, 16, 1024),
                 kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a = (kk / 4) * kBM * kRow + cw * 64 * kRow + (kk % 4) * 32;
        const uint32_t bo = (kk / 4) * N * kRow + (kk % 4) * 32;
        wgmma_ss(dp, sw128_desc(sdo + a, 16, 1024), sw128_desc(vs + bo, 16, 1024),
                 kk > 0);
      }
      wgmma_commit();
    };
    // dQ += dS K of tile n, one commit group: K's rows 16 kk .. 16 kk + 15
    // start 16 kk rows into each box, and the boxes lie N rows apart
    const auto issue_dq = [&](int n) {
      const uint32_t ks = sk + (n % S) * L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_rs(dq, dsf[kk], sw128_desc(ks + kk * 16 * kRow, N * kRow, 1024));
      wgmma_commit();
    };

    // P and dS of tile n in float, in place in sc; a mask only where it can
    // bite: keys past S, or past the warpgroup's first row. A row's keys
    // lie on the four lanes of its quad.
    const auto form_ds = [&](int n) {
      const int k0 = n * N;
      const bool edge = k0 + N > p.S || k0 + N - 1 > wq0;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = ex2(fmaf(sc[4 * j + e], sl2, nl0));
          float p1 = ex2(fmaf(sc[4 * j + 2 + e], sl2, nl1));
          if (edge) {
            const int kpos = k0 + 8 * j + c2 + e;
            p0 = kpos < p.S && kpos <= r0 ? p0 : 0.f;
            p1 = kpos < p.S && kpos <= r1 ? p1 : 0.f;
          }
          sc[4 * j + e] = p0 * (dp[4 * j + e] - d0);
          sc[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - d1);
        }
    };

    // Software pipeline inside the warpgroup: S and dP of tile n are issued
    // before dQ += dS K of tile n - 1, so tile n's exponentials run while
    // the tensor cores still work on tile n - 1's product; dS's fragments
    // are rewritten only after that product has retired.
    mbar_wait(qd_full, 0);
    if (cw == 1) pass_turn<true>(cw);
    mbar_wait(kv_full(0), 0);
    reg_fence(sc);
    reg_fence(dp);
    wait_turn<true>(cw);
    wgmma_fence();
    issue_sdp(0);
    pass_turn<true>(cw);
    wgmma_wait<0>();
    reg_fence(sc);
    reg_fence(dp);
    form_ds(0);
    to_fragments<N>(dsf, sc);
    for (int n = 1; n < ntiles; ++n) {
      mbar_wait(kv_full(n % S), (n / S) & 1);
      reg_fence(sc);
      reg_fence(dp);
      reg_fence(dq);
      reg_fence(dsf);
      wait_turn<true>(cw);
      wgmma_fence();
      issue_sdp(n);
      issue_dq(n - 1);
      pass_turn<true>(cw);
      wgmma_wait<1>();  // S and dP of tile n; tile n - 1's dQ may still run
      reg_fence(sc);
      reg_fence(dp);
      form_ds(n);
      wgmma_wait<0>();
      reg_fence(dq);
      reg_fence(dsf);
      if (lane == 0) mbar_arrive(empty((n - 1) % S));
      to_fragments<N>(dsf, sc);
    }
    reg_fence(dsf);
    reg_fence(dq);
    wait_turn<true>(cw);
    wgmma_fence();
    issue_dq(ntiles - 1);
    if (cw == 0) pass_turn<true>(cw);
    wgmma_wait<0>();
    reg_fence(dq);
    reg_fence(dsf);

    store_rows<D>(static_cast<bf16*>(p.dq) + b * p.dq_sb + h * p.dq_sh,
                  p.dq_ss, dq, p.scale, r0, c2, p.S);
  }
}

// ---- (b) dK and dV ----------------------------------------------------------

template <int D>
struct DkvLayout {
  static constexpr int kQT = 64;                  // queries a tile
  static constexpr int kStages = 4;
  static constexpr int kBoxes = D / kBox;
  static constexpr int kKBytes = kBM * D * 2;     // K or V of the block
  static constexpr int kQBytes = kQT * D * 2;     // a Q or dO tile
  static constexpr int kStatBytes = kQT * 4;      // a tile's L or D
  static constexpr int kBars = 1 + 2 * kStages;   // k/v, full[], empty[]
  static constexpr int kSmem = 2 * kKBytes + 2 * kStages * kQBytes +
                               2 * kStages * kStatBytes + 8 * kBars + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      FlashBwdParams p) {
  using L = DkvLayout<D>;
  constexpr int S = L::kStages, QT = L::kQT;
  // At D = 64: the ping-pong, K's and V's A fragments held in registers
  // (AR) and the software pipeline (PIPE) of (a). At D = 128 the dK and dV
  // accumulators take 128 registers a thread: the pipeline, which keeps
  // P^T's and dS^T's fragments live beside the next tile's scores, spilled
  // there, and the ping-pong slowed it (PERF.md, PR 27).
  constexpr bool PP = D == 64, AR = D == 64, PIPE = D == 64;
  extern __shared__ uint8_t smem_raw[];
  // K and V: kBoxes boxes of [kBM][64] each; each stage: a Q and a dO tile
  // (kBoxes boxes of [QT][64] each); then each stage's L and D; then the
  // barriers
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t sk = (base + 1023) & ~1023u;
  const uint32_t sv = sk + L::kKBytes;
  const uint32_t sq0 = sv + L::kKBytes;
  const auto sq = [&](int s) { return sq0 + 2 * s * L::kQBytes; };
  const auto sdo = [&](int s) { return sq(s) + L::kQBytes; };
  const uint32_t sst = sq0 + 2 * S * L::kQBytes;
  const auto sl = [&](int s) { return sst + 2 * s * L::kStatBytes; };
  const uint32_t kv_full = sst + 2 * S * L::kStatBytes;
  const auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  const auto empty = [&](int s) { return kv_full + 8 * (1 + S + s); };

  const int tid = threadIdx.x, wg = tid >> 7;
  // key tiles on z, first-first: the blocks with the most query tiles, of
  // every kv head, start first
  const int k0 = blockIdx.z * kBM;
  const int hk = blockIdx.x, b = blockIdx.y, rep = p.Hq / p.Hkv;
  // query tiles from the one holding key k0 to the last; the same for each
  // query head of the group
  const int m0 = k0 / QT, nq = (p.S + QT - 1) / QT - m0;
  const int total = rep * nq;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKBytes);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load(sk + c * kBM * kRow, &tk, kv_full, c * kBox, k0, hk, b);
        tma_load(sv + c * kBM * kRow, &tv, kv_full, c * kBox, k0, hk, b);
      }
      for (int it = 0; it < total; ++it) {
        const int s = it % S;
        const int h = hk * rep + it / nq, q0 = (m0 + it % nq) * QT;
        if (it >= S) mbar_wait(empty(s), ((it / S) - 1) & 1);
        mbar_expect_tx(full(s), 2 * L::kQBytes + 2 * L::kStatBytes);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load(sq(s) + c * QT * kRow, &tq, full(s), c * kBox, q0, h, b);
          tma_load(sdo(s) + c * QT * kRow, &tdo, full(s), c * kBox, q0, h, b);
        }
        const long long row = ((long long)b * p.Hq + h) * p.lse_ld + q0;
        bulk_load(sl(s), p.lse + row, L::kStatBytes, full(s));
        bulk_load(sl(s) + L::kStatBytes, p.delta + row, L::kStatBytes,
                  full(s));
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns keys k0 + 64 cw .. k0 + 64 cw + 63 --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1, t = tid & 127, lane = t & 31;
    const int g = lane >> 2, c2 = 2 * (lane & 3);
    const int kw0 = k0 + 64 * cw;
    const int kr0 = kw0 + 16 * (t >> 5) + g, kr1 = kr0 + 8;  // this thread's keys
    const float sl2 = p.scale * kLog2e;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    float st[QT / 2], dpt[QT / 2];         // S^T then P^T; dP^T then dS^T
    uint32_t pf[QT / 16][4], dsf[QT / 16][4];  // their A fragments

    // K's and V's A fragments in registers (AR), else read from shared
    // memory by each product
    uint32_t kf[AR ? D / 16 : 1][4], vf[AR ? D / 16 : 1][4];
    // S^T = K Q^T and dP^T = V dO^T of iteration it for the warpgroup's 64
    // keys, one commit group
    const auto issue_sdp = [&](int it) {
      const int s = it % S;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a = (kk / 4) * kBM * kRow + cw * 64 * kRow + (kk % 4) * 32;
        const uint32_t bo = (kk / 4) * QT * kRow + (kk % 4) * 32;
        if constexpr (AR)
          wgmma_rs_k(st, kf[kk], sw128_desc(sq(s) + bo, 16, 1024), kk > 0);
        else
          wgmma_ss(st, sw128_desc(sk + a, 16, 1024),
                   sw128_desc(sq(s) + bo, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a = (kk / 4) * kBM * kRow + cw * 64 * kRow + (kk % 4) * 32;
        const uint32_t bo = (kk / 4) * QT * kRow + (kk % 4) * 32;
        if constexpr (AR)
          wgmma_rs_k(dpt, vf[kk], sw128_desc(sdo(s) + bo, 16, 1024), kk > 0);
        else
          wgmma_ss(dpt, sw128_desc(sv + a, 16, 1024),
                   sw128_desc(sdo(s) + bo, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // dV += P^T dO and dK += dS^T Q of iteration it, one commit group, dO
    // and Q MN-major: their rows 16 kk .. 16 kk + 15 start 16 kk rows into
    // each box, boxes QT rows apart
    const auto issue_dkv = [&](int it) {
      const int s = it % S;
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        wgmma_rs(dv, pf[kk], sw128_desc(sdo(s) + kk * 16 * kRow, QT * kRow, 1024));
        wgmma_rs(dk, dsf[kk], sw128_desc(sq(s) + kk * 16 * kRow, QT * kRow, 1024));
      }
      wgmma_commit();
    };

    // P^T and dS^T of iteration it in float, in place in st and dpt: column
    // 8 j + c2 + e is query q0 + 8 j + c2 + e. A mask only where it can
    // bite: queries past S, or before the warpgroup's last key
    const auto form_ds = [&](int it) {
      const int s = it % S, q0 = (m0 + it % nq) * QT;
      const float* lt = reinterpret_cast<const float*>(smem_raw + (sl(s) - base));
      const float* dt = lt + QT;
      const bool edge = q0 + QT > p.S || q0 < kw0 + 63;
#pragma unroll
      for (int j = 0; j < QT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + c2 + e;
          const float nl = -lt[c] * kLog2e, dl = dt[c];
          float p0 = ex2(fmaf(st[4 * j + e], sl2, nl));
          float p1 = ex2(fmaf(st[4 * j + 2 + e], sl2, nl));
          if (edge) {
            const int qpos = q0 + c;
            p0 = qpos < p.S && qpos >= kr0 ? p0 : 0.f;
            p1 = qpos < p.S && qpos >= kr1 ? p1 : 0.f;
          }
          st[4 * j + e] = p0;
          st[4 * j + 2 + e] = p1;
          dpt[4 * j + e] = p0 * (dpt[4 * j + e] - dl);
          dpt[4 * j + 2 + e] = p1 * (dpt[4 * j + 2 + e] - dl);
        }
    };

    mbar_wait(kv_full, 0);
    if constexpr (AR) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        load_a_fragment(kf[kk], sk, kBM, cw * 64 + 16 * (t >> 5), 16 * kk,
                        lane);
        load_a_fragment(vf[kk], sv, kBM, cw * 64 + 16 * (t >> 5), 16 * kk,
                        lane);
      }
    }
    // With PIPE the software pipeline of (a): S^T and dP^T of iteration it
    // are issued before dV and dK of iteration it - 1, whose fragments are
    // rewritten only after those products have retired. Without it, both
    // retire before the exponentials.
    if (cw == 1) pass_turn<PP>(cw);
    mbar_wait(full(0), 0);
    reg_fence(st);
    reg_fence(dpt);
    wait_turn<PP>(cw);
    wgmma_fence();
    issue_sdp(0);
    pass_turn<PP>(cw);
    wgmma_wait<0>();
    reg_fence(st);
    reg_fence(dpt);
    form_ds(0);
    to_fragments<QT>(pf, st);
    to_fragments<QT>(dsf, dpt);
    for (int it = 1; it < total; ++it) {
      mbar_wait(full(it % S), (it / S) & 1);
      reg_fence(st);
      reg_fence(dpt);
      reg_fence(dk);
      reg_fence(dv);
      reg_fence(pf);
      reg_fence(dsf);
      wait_turn<PP>(cw);
      wgmma_fence();
      if constexpr (PIPE) {
        issue_sdp(it);
        issue_dkv(it - 1);
      } else {
        issue_dkv(it - 1);
        issue_sdp(it);
      }
      pass_turn<PP>(cw);
      if constexpr (PIPE) {
        wgmma_wait<1>();  // S^T and dP^T of it; it - 1's dV, dK may still run
        reg_fence(st);
        reg_fence(dpt);
        form_ds(it);
      }
      wgmma_wait<0>();
      reg_fence(st);
      reg_fence(dpt);
      reg_fence(dk);
      reg_fence(dv);
      reg_fence(pf);
      reg_fence(dsf);
      if (lane == 0) mbar_arrive(empty((it - 1) % S));
      if constexpr (!PIPE) form_ds(it);
      to_fragments<QT>(pf, st);
      to_fragments<QT>(dsf, dpt);
    }
    reg_fence(pf);
    reg_fence(dsf);
    reg_fence(dk);
    reg_fence(dv);
    wait_turn<PP>(cw);
    wgmma_fence();
    issue_dkv(total - 1);
    if (cw == 0) pass_turn<PP>(cw);
    wgmma_wait<0>();
    reg_fence(dk);
    reg_fence(dv);
    reg_fence(pf);
    reg_fence(dsf);

    store_rows<D>(static_cast<bf16*>(p.dk) + b * p.dk_sb + hk * p.dk_sh,
                  p.dk_ss, dk, p.scale, kr0, c2, p.S);
    store_rows<D>(static_cast<bf16*>(p.dv) + b * p.dv_sb + hk * p.dv_sh,
                  p.dv_ss, dv, 1.f, kr0, c2, p.S);
  }
}

template <int D>
const char* run(const FlashBwdParams& p, cudaStream_t stream) {
  const char* refused =
      "flash_attention_bwd: cuTensorMapEncodeTiled refused an operand (TMA "
      "takes strides that are multiples of 16 bytes on 16-byte aligned "
      "storage)";
  const int tiles = (p.S + kBM - 1) / kBM;
  {
    using L = DqLayout<D>;
    CUtensorMap tq, tk, tv, tdo;
    if (!encode_operand(&tq, p.q, p.B, p.Hq, p.S, D, p.q_sb, p.q_sh, p.q_ss,
                        kBM) ||
        !encode_operand(&tk, p.k, p.B, p.Hkv, p.S, D, p.k_sb, p.k_sh, p.k_ss,
                        L::kN) ||
        !encode_operand(&tv, p.v, p.B, p.Hkv, p.S, D, p.v_sb, p.v_sh, p.v_ss,
                        L::kN) ||
        !encode_operand(&tdo, p.dout, p.B, p.Hq, p.S, D, p.do_sb, p.do_sh,
                        p.do_ss, kBM))
      return refused;
    cudaFuncSetAttribute(bwd_dq_wgmma_kernel<D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         L::kSmem);
    if (cudaPeekAtLastError() != cudaSuccess) return nullptr;
    bwd_dq_wgmma_kernel<D><<<dim3(p.Hq, p.B, tiles), kThreads, L::kSmem,
                             stream>>>(tq, tk, tv, tdo, p);
    if (cudaPeekAtLastError() != cudaSuccess) return nullptr;
  }
  using L = DkvLayout<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_operand(&tq, p.q, p.B, p.Hq, p.S, D, p.q_sb, p.q_sh, p.q_ss,
                      L::kQT) ||
      !encode_operand(&tk, p.k, p.B, p.Hkv, p.S, D, p.k_sb, p.k_sh, p.k_ss,
                      kBM) ||
      !encode_operand(&tv, p.v, p.B, p.Hkv, p.S, D, p.v_sb, p.v_sh, p.v_ss,
                      kBM) ||
      !encode_operand(&tdo, p.dout, p.B, p.Hq, p.S, D, p.do_sb, p.do_sh,
                      p.do_ss, L::kQT))
    return refused;
  cudaFuncSetAttribute(bwd_dkdv_wgmma_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (cudaPeekAtLastError() != cudaSuccess) return nullptr;
  bwd_dkdv_wgmma_kernel<D><<<dim3(p.Hkv, p.B, tiles), kThreads, L::kSmem,
                             stream>>>(tq, tk, tv, tdo, p);
  return nullptr;
}

template <int D>
void info_of(int out[8]) {
  cudaFuncAttributes a{}, b{};
  cudaFuncGetAttributes(&a, bwd_dq_wgmma_kernel<D>);
  cudaFuncGetAttributes(&b, bwd_dkdv_wgmma_kernel<D>);
  out[0] = a.numRegs;
  out[1] = DqLayout<D>::kSmem;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = DqLayout<D>::kStages;
  out[4] = b.numRegs;
  out[5] = DkvLayout<D>::kSmem;
  out[6] = static_cast<int>(b.localSizeBytes);
  out[7] = DkvLayout<D>::kStages;
}

}  // namespace

const char* launch_flash_bwd_wgmma(const FlashBwdParams& p,
                                   cudaStream_t stream) {
  return p.D == 128 ? run<128>(p, stream) : run<64>(p, stream);
}

void flash_bwd_wgmma_info(int D, int out[8]) {
  if (D == 128)
    info_of<128>(out);
  else
    info_of<64>(out);
}
