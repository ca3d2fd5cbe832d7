// Flash attention forward in bfloat16 for Hopper (sm_90a), head dims 64
// and 128: a TMA ring, wgmma on both products, warp specialization.
//
// Replaces: repro/kernels/flash_attention.py `flash_attention` (pallas_call
// at :91, body `_flash_kernel` :31) for bfloat16 at D = 64 and 128, the
// head dims of the served models (llama3.2-1b, qwen3-1.7b). D = 16 and 32
// stay on the mma.sync kernel of flash_attention.cu (wgmma would need a
// 32- or 64-byte swizzle and other TMA boxes for them, and no model of the
// repo serves them); float32 stays on its CUDA-core kernel there.
//
// The function is the Pallas kernel's, as flash_attention.cu states it:
// s = q.k^T * scale in float32, keys at or past kv_end and (causal) keys past
// the query's position set to -1e30 (never -inf), running max, sum and
// accumulator in float32, P.V with P carried as a bf16 high part plus a bf16
// remainder (16 significant bits), output acc / max(l, 1e-30) in bfloat16.
// The exponentials are ex2.approx with scale * log2(e) folded into the
// scores: that moves results by a few float32 ulps, far inside one bf16 step.
//
// What bounds it: operations. Per (query, key) pair 4 D flops of the
// nominal function against 2 D bytes read once per query tile; qwen3-1.7b's
// prefill layer (B 4, Hq 16, S 4,096, D 128, causal) is 2.75e11 flops,
// 0.278 ms at the 989 TFLOP/s bf16 tensor-core peak. P's two parts double
// the P.V products, so the tensor cores do 1.5x that: 0.42 ms at the peak.
// Beside them, each score takes ~10 instructions of softmax and split on
// the CUDA cores, which the design overlaps with the products.
//
// Design, one block per (128 queries, q head, batch), 384 threads:
//   * warpgroup 0 is the producer: after setmaxnreg.dec to 24 registers,
//     one thread loads Q once and then keeps the K and V tiles (128 keys)
//     in flight through TMA into a ring of kStages stages (4 at D = 64, 3 at
//     D = 128: what shared memory holds; at D = 128, 3 stages ran faster
//     than 2), each tile completing on its own
//     mbarrier (K and V apart, so q.k^T starts before V lands) and each
//     stage freed by an "empty" mbarrier that the consumers arrive on.
//   * warpgroups 1 and 2 are the consumers (setmaxnreg.inc to 240), 64
//     query rows each, so one K/V load feeds 128 queries: 128 query rows a
//     block, not the rep heads of one kv head, since rep differs between
//     models (2 for qwen3, 4 for llama3.2) while 128 rows fit both; the
//     rep heads read the same K/V tiles from L2. A tile of 128 keys keeps
//     the scores (64), P's two parts (64) and the D = 128 accumulator (64)
//     in registers with room: ptxas reports 168 registers a thread before
//     setmaxnreg and no spills.
//   * S = Q K^T: wgmma m64n128k16, Q and K both K-major in 128-byte-swizzled
//     shared memory (the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B;
//     a 128-byte box is 64 columns, so D = 128 takes two boxes).
//   * O += P V: wgmma m64nDk16 with A = P from registers (the score
//     accumulator's layout per warp is the A fragment's, as in
//     FlashAttention-3) and B = V MN-major in shared memory; two products
//     per 16 keys, P's high part and its remainder.
//   * Inside a warpgroup, q.k^T of tile n and P.V of tile n - 1 are in
//     flight together, and tile n's softmax runs under P.V. Between the two
//     warpgroups, a ping-pong on named barriers 1 and 2 (FlashAttention-3's
//     order): a warpgroup issues its products only after the other has
//     issued its own, so one's softmax runs under the other's products.
//   * Masks only on a tile that crosses the causal diagonal of the
//     warpgroup's rows or holds kv_end; tiles wholly above the block's
//     diagonal are never loaded. Query tiles run last-first (longest causal
//     rows first). Ragged Sq and Skv: TMA fills rows past the tensor with
//     zeros, and the mask drops keys at or past kv_end.
//   * Training (FlashParams.o_lo set) runs a second instantiation whose
//     epilogue also writes the output's bf16 remainder and each row's
//     natural log-sum-exp, which the backward (flash_attention_bwd_sm90.cu)
//     reads instead of rebuilding the statistics; serving's instantiation
//     has no such epilogue.
//   * Operands are read in place through 4-D tensor maps over (D, S, H, B)
//     built per call from the sizes and strides, so the model's
//     head-transposed views need no copy; TMA takes strides that are
//     multiples of 16 bytes on 16-byte aligned storage, and the encode
//     fails (and the launch raises) on anything else.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flash_common.cuh"
#include "flash_sm90.cuh"
#include "kernels.h"

namespace {

using flash::kMinL;
using flash::kNegInf;
using flash::split_bf16;
using sm90::encode_operand;
using sm90::ex2;
using sm90::kBox;
using sm90::kLn2;
using sm90::kLog2e;
using sm90::kRow;
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
using sm90::wgmma_ss;
using sm90::wgmma_wait;
constexpr int kBM = 128;       // queries a block: two consumer warpgroups
constexpr int kBN = 128;       // keys a tile
constexpr int kThreads = 384;  // producer + two consumer warpgroups

template <int D>
struct Layout {
  static constexpr int kStages = D == 128 ? 3 : 4;
  static constexpr int kBoxes = D / kBox;         // boxes per row of a tile
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kTileBytes = kBN * D * 2;  // one K or V tile
  static constexpr int kBars = 1 + 3 * kStages;   // q, k[], v[], empty[]
  // + 1,024 bytes to align the base: 128-byte swizzle repeats every 1,024
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kTileBytes + 8 * kBars + 1024;
};

// Stats: training's statistics in the epilogue (FlashParams: o_lo, lse); a
// template parameter, so serving runs the kernel without that epilogue.
template <int D, bool Stats>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, FlashParams p) {
  using L = Layout<D>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  // Q: kBoxes boxes of [kBM][64]; each K or V stage: kBoxes boxes of
  // [kBN][64]; then the barriers
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + L::kQBytes;
  const uint32_t sv = sk + S * L::kTileBytes;
  const uint32_t q_full = sv + S * L::kTileBytes;
  const auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  const auto v_full = [&](int s) { return q_full + 8 * (1 + S + s); };
  const auto empty = [&](int s) { return q_full + 8 * (1 + 2 * S + s); };

  const int tid = threadIdx.x, wg = tid >> 7;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (p.Hq / p.Hkv);
  const int kv_stop = p.causal ? min(p.kv_end, q0 + kBM) : p.kv_end;
  const int ntiles = kv_stop > 0 ? (kv_stop + kBN - 1) / kBN : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load(sq + c * kBM * kRow, &tq, q_full, c * kBox, q0, h, b);
      for (int n = 0; n < ntiles; ++n) {
        const int s = n % S;
        if (n >= S) mbar_wait(empty(s), ((n / S) - 1) & 1);
        const uint32_t ks = sk + s * L::kTileBytes, vs = sv + s * L::kTileBytes;
        mbar_expect_tx(k_full(s), L::kTileBytes);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(ks + c * kBN * kRow, &tk, k_full(s), c * kBox, n * kBN, hk,
                   b);
        mbar_expect_tx(v_full(s), L::kTileBytes);
        for (int c = 0; c < L::kBoxes; ++c)
          tma_load(vs + c * kBN * kRow, &tv, v_full(s), c * kBox, n * kBN, hk,
                   b);
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

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[kBN / 2];                          // scores, then P, of a tile
    uint32_t ph[kBN / 16][4], pl[kBN / 16][4];  // P's A fragments: high, low
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    // s = q k^T of tile n into sc, one commit group: D / 16 k-steps of 16
    // columns, 32 bytes apart inside a 128-byte box row
    const auto issue_qk = [&](int n) {
      const uint32_t ks = sk + (n % S) * L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk / 4) * kBN * kRow + (kk % 4) * 32;
        wgmma_ss(sc,
                 sw128_desc(sq + (kk / 4) * kBM * kRow + cw * 64 * kRow +
                                (kk % 4) * 32,
                            16, 1024),
                 sw128_desc(ks + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // acc += P V of tile n, one commit group: V's rows 16 kk .. 16 kk + 15
    // start 16 kk rows into each box, and the boxes lie kBN rows apart
    const auto issue_pv = [&](int n) {
      const uint32_t vs = sv + (n % S) * L::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint64_t dv = sw128_desc(vs + kk * 16 * kRow, kBN * kRow, 1024);
        wgmma_rs(acc, ph[kk], dv);
        wgmma_rs(acc, pl[kk], dv);
      }
      wgmma_commit();
    };
    // Online softmax of tile n's scores: sc becomes P (in log2 units, scale
    // folded in), m and l move on, and (a0, a1) rescale acc. A mask only
    // where it can bite: keys at or past kv_end, or (causal) past the
    // warpgroup's first row. A row's keys lie on the four lanes of its
    // group g.
    const auto softmax = [&](int n, float& a0, float& a1) {
      const int k0 = n * kBN;
      float mul = sl2;  // applied in the exponent's fma
      if (k0 + kBN > p.kv_end || (p.causal && k0 + kBN - 1 > wq0)) {
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + 8 * j + c2 + e;
            const bool in = kpos < p.kv_end;
            const bool ok0 = in && (!p.causal || kpos <= r0);
            const bool ok1 = in && (!p.causal || kpos <= r1);
            sc[4 * j + e] = ok0 ? sc[4 * j + e] * sl2 : kNegInf;
            sc[4 * j + 2 + e] = ok1 ? sc[4 * j + 2 + e] * sl2 : kNegInf;
          }
        mul = 1.f;
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // the scale is positive, so max(s) * scale is max(s * scale)
      const float mn0 = fmaxf(m0, mx0 * mul), mn1 = fmaxf(m1, mx1 * mul);
      a0 = ex2(m0 - mn0);
      a1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        sc[4 * j] = ex2(fmaf(sc[4 * j], mul, -mn0));
        sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], mul, -mn0));
        sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], mul, -mn1));
        sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], mul, -mn1));
        rs0 += sc[4 * j] + sc[4 * j + 1];
        rs1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * a0 + rs0;  // this thread's share; summed at the end
      l1 = l1 * a1 + rs1;
    };
    // P's A fragments for each 16 keys: score tiles 2 kk and 2 kk + 1
    const auto split = [&]() {
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        split_bf16(sc[8 * kk], sc[8 * kk + 1], ph[kk][0], pl[kk][0]);
        split_bf16(sc[8 * kk + 2], sc[8 * kk + 3], ph[kk][1], pl[kk][1]);
        split_bf16(sc[8 * kk + 4], sc[8 * kk + 5], ph[kk][2], pl[kk][2]);
        split_bf16(sc[8 * kk + 6], sc[8 * kk + 7], ph[kk][3], pl[kk][3]);
      }
    };
    const auto parity = [](int n) { return static_cast<uint32_t>(n / S) & 1; };

    // Software pipeline inside the warpgroup: q k^T of tile n and P V of
    // tile n - 1 are in flight together, and tile n's softmax runs while
    // the tensor cores still work on P V. Ping-pong between the warpgroups
    // around each issue: warpgroup 0 issues first; warpgroup 1 hands over
    // the first turn and skips its last hand-off, so no arrival is left
    // over at exit. The barrier ids are immediates, so ptxas reserves only
    // those two.
    const auto wait_turn = [&]() {
      if (cw == 0)
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
      else
        asm volatile("bar.sync 2, 256;\n" ::: "memory");
    };
    const auto pass_turn = [&]() {
      if (cw == 0)
        asm volatile("bar.arrive 2, 256;\n" ::: "memory");
      else
        asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    };
    mbar_wait(q_full, 0);
    if (ntiles > 0) {
      if (cw == 1) pass_turn();
      float a0, a1;
      mbar_wait(k_full(0), 0);
      reg_fence(sc);
      wait_turn();
      wgmma_fence();
      issue_qk(0);
      pass_turn();
      wgmma_wait<0>();
      reg_fence(sc);
      softmax(0, a0, a1);  // acc is still 0: nothing to rescale
      split();
      for (int n = 1; n < ntiles; ++n) {
        mbar_wait(k_full(n % S), parity(n));
        mbar_wait(v_full((n - 1) % S), parity(n - 1));
        reg_fence(sc);
        reg_fence(ph);
        reg_fence(pl);
        reg_fence(acc);
        wait_turn();
        wgmma_fence();
        issue_qk(n);
        issue_pv(n - 1);
        pass_turn();
        wgmma_wait<1>();  // q k^T done; P V may still run
        reg_fence(sc);
        softmax(n, a0, a1);
        wgmma_wait<0>();
        reg_fence(acc);
        reg_fence(ph);
        reg_fence(pl);
        if (lane == 0) mbar_arrive(empty((n - 1) % S));
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          acc[4 * i] *= a0;
          acc[4 * i + 1] *= a0;
          acc[4 * i + 2] *= a1;
          acc[4 * i + 3] *= a1;
        }
        split();
      }
      const int n = ntiles - 1;
      mbar_wait(v_full(n % S), parity(n));
      reg_fence(ph);
      reg_fence(pl);
      reg_fence(acc);
      wait_turn();
      wgmma_fence();
      issue_pv(n);
      if (cw == 0) pass_turn();
      wgmma_wait<0>();
      reg_fence(acc);
      if (lane == 0) mbar_arrive(empty(n % S));
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, kMinL), inv1 = 1.f / fmaxf(l1, kMinL);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                       h * p.o_sh;
    if constexpr (!Stats) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int col = 8 * i + c2;
        if (r0 < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(o + (long long)r0 * p.o_ss +
                                             col) =
              __floats2bfloat162_rn(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
        if (r1 < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(o + (long long)r1 * p.o_ss +
                                             col) =
              __floats2bfloat162_rn(acc[4 * i + 2] * inv1,
                                    acc[4 * i + 3] * inv1);
      }
    } else {
      // training: the output's bf16 remainder beside it, and the rows'
      // log-sum-exp, natural log: (m + log2 l) ln 2, m in the exponent's
      // units (scale * log2 e folded in). Every row of the grid's last
      // tile gets one (rows past Sq saw zero queries), so the backward's
      // padded reads of the LSE find finite values.
      __nv_bfloat16* olo = static_cast<__nv_bfloat16*>(p.o_lo) +
                           b * p.olo_sb + h * p.olo_sh;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const int col = 8 * i + c2;
        uint32_t hi, lo;
        if (r0 < p.Sq) {
          split_bf16(acc[4 * i] * inv0, acc[4 * i + 1] * inv0, hi, lo);
          *reinterpret_cast<uint32_t*>(o + (long long)r0 * p.o_ss + col) = hi;
          *reinterpret_cast<uint32_t*>(olo + (long long)r0 * p.olo_ss + col) =
              lo;
        }
        if (r1 < p.Sq) {
          split_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1, hi, lo);
          *reinterpret_cast<uint32_t*>(o + (long long)r1 * p.o_ss + col) = hi;
          *reinterpret_cast<uint32_t*>(olo + (long long)r1 * p.olo_ss + col) =
              lo;
        }
      }
      if ((lane & 3) == 0) {
        float* lse = p.lse + ((long long)b * p.Hq + h) * p.lse_ld;
        lse[r0] = (m0 + log2f(fmaxf(l0, kMinL))) * kLn2;
        lse[r1] = (m1 + log2f(fmaxf(l1, kMinL))) * kLn2;
      }
    }
  }
}

template <int D, bool Stats>
const char* run_wgmma(const FlashParams& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode_operand(&tq, p.q, p.B, p.Hq, p.Sq, D, p.q_sb, p.q_sh, p.q_ss,
                      kBM) ||
      !encode_operand(&tk, p.k, p.B, p.Hkv, p.Skv, D, p.k_sb, p.k_sh, p.k_ss,
                      kBN) ||
      !encode_operand(&tv, p.v, p.B, p.Hkv, p.Skv, D, p.v_sb, p.v_sh, p.v_ss,
                      kBN))
    return "flash_attention: cuTensorMapEncodeTiled refused an operand (TMA "
           "takes strides that are multiples of 16 bytes on 16-byte aligned "
           "storage)";
  constexpr int smem = Layout<D>::kSmem;
  cudaFuncSetAttribute(flash_wgmma_kernel<D, Stats>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cudaPeekAtLastError() != cudaSuccess) return nullptr;
  const dim3 grid((p.Sq + kBM - 1) / kBM, p.Hq, p.B);
  flash_wgmma_kernel<D, Stats>
      <<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return nullptr;
}

}  // namespace

const char* launch_flash_wgmma(const FlashParams& p, cudaStream_t stream) {
  if (p.o_lo != nullptr)
    return p.D == 128 ? run_wgmma<128, true>(p, stream)
                      : run_wgmma<64, true>(p, stream);
  return p.D == 128 ? run_wgmma<128, false>(p, stream)
                    : run_wgmma<64, false>(p, stream);
}

void flash_wgmma_info(int D, int out[4]) {
  cudaFuncAttributes a{};
  if (D == 128)
    cudaFuncGetAttributes(&a, flash_wgmma_kernel<128, false>);
  else
    cudaFuncGetAttributes(&a, flash_wgmma_kernel<64, false>);
  out[0] = a.numRegs;
  out[1] = D == 128 ? Layout<128>::kSmem : Layout<64>::kSmem;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = D == 128 ? Layout<128>::kStages : Layout<64>::kStages;
}
