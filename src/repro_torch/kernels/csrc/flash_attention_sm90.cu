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
#include "kernels.h"

namespace {

using flash::kMinL;
using flash::kNegInf;
using flash::split_bf16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBM = 128;       // queries a block: two consumer warpgroups
constexpr int kBN = 128;       // keys a tile
constexpr int kBox = 64;       // columns of a TMA box: 128 bytes of bf16
constexpr int kRow = 128;      // bytes of a box row in shared memory
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` of TMA traffic on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: the box of `map` at coordinates (c0, c1, c2, c3) into shared memory
// at dst, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address addr:
// lbo the byte stride between 64-column boxes (read for an MN-major
// operand wider than one box), sbo between groups of 8 rows.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's commit groups are in flight
// (they complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x, the MUFU approximation (relative error ~2^-22, far inside a bf16
// step); results below 2^-126 flush to 0, weights no sum can see.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Pins registers that a wgmma reads or writes asynchronously, so the
// compiler neither moves their other accesses across the fences nor reuses
// them while the product is in flight.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 128, f32) = (accumulate ? d : 0) + A (64 x 16) B (16 x 128), A and
// B K-major in 128-byte-swizzled shared memory (descriptors da, db)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) += A (64 x 16, bf16 fragments in registers) B (16 x
// 128), B MN-major in 128-byte-swizzled shared memory (descriptor db)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 fragments in registers) B (16 x
// 64), B MN-major in 128-byte-swizzled shared memory (descriptor db)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
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
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = 8 * i + c2;
      if (r0 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(o + (long long)r0 * p.o_ss + col) =
            __floats2bfloat162_rn(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
      if (r1 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(o + (long long)r1 * p.o_ss + col) =
            __floats2bfloat162_rn(acc[4 * i + 2] * inv1,
                                  acc[4 * i + 3] * inv1);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so the build links
// no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over a (B, H, S, D) bf16 operand with element strides (sb, sh,
// ss, 1), seen as (D, S, H, B) innermost first; boxes of 64 columns x rows.
// A dim of extent 1 never moves, so its stride is replaced by one TMA takes.
bool encode_operand(CUtensorMap* map, const void* ptr, int B, int H, int S,
                    int D, long long sb, long long sh, long long ss,
                    int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  if (S == 1) ss = D;
  if (H == 1) sh = ss * S;
  if (B == 1) sb = sh * H;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kBox, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
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
  cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cudaPeekAtLastError() != cudaSuccess) return nullptr;
  const dim3 grid((p.Sq + kBM - 1) / kBM, p.Hq, p.B);
  flash_wgmma_kernel<D><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return nullptr;
}

}  // namespace

const char* launch_flash_wgmma(const FlashParams& p, cudaStream_t stream) {
  return p.D == 128 ? run_wgmma<128>(p, stream) : run_wgmma<64>(p, stream);
}

void flash_wgmma_info(int D, int out[4]) {
  cudaFuncAttributes a{};
  if (D == 128)
    cudaFuncGetAttributes(&a, flash_wgmma_kernel<128>);
  else
    cudaFuncGetAttributes(&a, flash_wgmma_kernel<64>);
  out[0] = a.numRegs;
  out[1] = D == 128 ? Layout<128>::kSmem : Layout<64>::kSmem;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = D == 128 ? Layout<128>::kStages : Layout<64>::kStages;
}
