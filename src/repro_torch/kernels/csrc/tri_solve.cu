// Batched blocked triangular substitution: L Y = X (top-down) or
// L^T Y = X (bottom-up), in place on the RHS slabs.
//
// Replaces: repro/kernels/frontal_cholesky.py `tri_solve_batch`
//   (pallas_call at :364; body `_tri_solve_batch_kernel` :289).
//
// `l` holds the lower factor of each front with batch stride `l_bstride` and
// row stride `ldl`, so L11 is read straight out of a factored (B, M, M)
// workspace stack without a copy. Only entries on or below the diagonal
// enter the arithmetic. Unit-diagonal pad rows pass their RHS through.
//
// What bounds it: the dependent chain of the substitution, not bytes or
// flops (the root front's 131 KB of L need 0.00004 ms at the memory rate;
// its chain takes microseconds). Tensor cores are not used: the factor is
// f32 with TF32 off, and the work is a latency chain, not a product.
//
// What the design does about it, in two variants chosen by P alone:
//
// * P <= 32, tri_solve_warp_kernel: a segment of G = 8, 16 or 32 lanes per
//   (front, RHS column), 32 / G segments a warp, 8 warps a block. Each lane
//   loads its row (lower) or column (upper) of tril(L) straight into
//   registers, with the reciprocal of its diagonal, before the chain, so the
//   chain is P register shuffles: no memory access, division or block
//   barrier in it. The whole front is one panel whatever bs is.
// * P > 32, tri_solve_block_kernel: a block per (front, RHS tile of kt
//   columns), the slab in shared memory. Before the chain, one warp per
//   diagonal tile inverts all P / bs tiles into shared memory: they do not
//   depend on X (the TPU kernel inverts one per panel step). The
//   off-diagonal strips (lower: the column strip L[lo+bs:, lo:lo+bs]; upper:
//   the row band L[lo:lo+bs, :lo], read transposed) stream through a ring of
//   2-3 shared-memory stages with cp.async, 16-byte copies where the
//   address allows and 4-byte ones where not, so the strip of panel t + 1
//   arrives while panel t computes. The chain is then P / bs steps that
//   touch only shared memory and registers: xp = inv_tt . rhs (bs x kt dot
//   products), then the rank-bs update of the remaining rows over all
//   threads, two block barriers a step; every index of a step is fixed per
//   thread before the chain, so it divides nothing. Where shared memory
//   cannot hold the slab, every inverse and the ring at once (shapes the
//   solve path never produces), the launcher shrinks the ring's chunks,
//   then inverts each tile at its own step, then leaves the slab in device
//   memory. That last level cannot go: at kt = 1 the binding accepts a
//   slab of P * 4 bytes up to the whole 227 KB a block may hold, which
//   leaves no room for an inverse tile and the ring, so narrowing the RHS
//   tile cannot bring such a slab into shared memory.
#include "kernels.h"
#include "tile_invert.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
using tile::invert_tile;
constexpr size_t kSmemMax = 227 * 1024;  // a block's opt-in maximum (sm_90)

// ---- P <= 32: a segment of G lanes per (front, RHS column) ----------------

template <int G, bool LOWER>
__global__ void __launch_bounds__(kThreads)
tri_solve_warp_kernel(const float* __restrict__ l, long long l_bstride,
                      int ldl, float* __restrict__ x, int B, int P, int K) {
  constexpr int kSegs = 32 / G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int seg = lane / G, r = lane % G;
  const long long item =
      ((long long)blockIdx.x * kWarps + warp) * kSegs + seg;
  const bool active = item < (long long)B * K;
  const long long f = active ? item / K : 0;
  const int col = active ? static_cast<int>(item - f * K) : 0;
  const float* L = l + f * l_bstride;
  // lower: a[j] = L[r, j] for j < r (this lane's row); upper: a[j] = L[j, r]
  // for r < j < P (row j read by the segment's lanes side by side)
  const bool row = active && r < P;
  float a[G];
#pragma unroll
  for (int j = 0; j < G; ++j)
    a[j] = row && (LOWER ? j < r : j > r && j < P)
               ? L[LOWER ? (size_t)r * ldl + j : (size_t)j * ldl + r]
               : 0.f;
  const float dinv = row ? 1.f / L[(size_t)r * ldl + r] : 0.f;
  float* xr = x + ((size_t)f * P + r) * K + col;
  float v = row ? *xr : 0.f;
#pragma unroll
  for (int s = 0; s < G; ++s) {
    const int j = LOWER ? s : G - 1 - s;
    if (j < P) {
      const float y = __shfl_sync(kFull, v * dinv, j, G);
      v = r == j ? y : fmaf(-a[j], y, v);
    }
  }
  if (row) *xr = v;
}

// ---- P > 32: a block per (front, RHS tile) ----------------------------------

// Row stride of an inverse tile and of a lower-strip row: bs rounded up to a
// multiple of 4, made 4 x an odd number, so 16-byte rows start 16-byte
// aligned and threads on neighbouring rows hit distinct banks.
__host__ __device__ inline int tile_stride(int bs) {
  const int bs4 = (bs + 3) & ~3;
  return 4 * ((bs4 / 4) | 1);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` (0..2) of this thread's most recent groups
// are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <bool LOWER>
__device__ void invert(float* C, int cs, int bs, int lane) {
  if (bs == 32)
    invert_tile<LOWER, 32>(C, cs, bs, lane);
  else
    invert_tile<LOWER, 0>(C, cs, bs, lane);
}

// Shared memory of the block kernel, in floats, in this order: the inverse
// tiles (np of them, or one), the ring of nst stages of ch strip rows
// (lower) or columns (upper), xp (kt columns of bs4), the slab (P rows of
// kt | 1, odd so that neighbouring rows hit distinct banks).
struct BlockPlan {
  int ch, nst;
  bool inv_all, slab;
  size_t smem;
};

size_t block_smem(int P, int kt, int bs, bool lower, int ch, int nst,
                  bool inv_all, bool slab) {
  const int bs4 = (bs + 3) & ~3, cs = tile_stride(bs);
  const size_t inv = (size_t)(inv_all ? P / bs : 1) * bs * cs;
  const size_t ring = (size_t)nst * (lower ? ch * cs : bs4 * ch);
  const size_t rest = (size_t)kt * bs4 + (slab ? (size_t)P * (kt | 1) : 0);
  return (inv + ring + rest) * sizeof(float);
}

// The first layout that fits, preferring in turn the slab in shared memory,
// every inverse ahead of the chain, whole strips, and 3 stages over 2.
BlockPlan plan_block(int P, int kt, int bs, bool lower) {
  const int whole = (P - bs + 3) & ~3;
  for (int slab = 1; slab >= 0; --slab)
    for (int inv_all = 1; inv_all >= 0; --inv_all)
      for (int ch = whole;; ch = ((ch + 1) / 2 + 3) & ~3) {
        for (int nst = 3; nst >= 2; --nst) {
          const size_t smem =
              block_smem(P, kt, bs, lower, ch, nst, inv_all, slab);
          if (smem <= kSmemMax) return {ch, nst, inv_all == 1, slab == 1, smem};
        }
        if (ch <= 4) break;
      }
  // unreachable for bs <= 32 and kt <= 32 (about 10 KB at the last step)
  return {4, 2, false, false, block_smem(P, kt, bs, lower, 4, 2, false, false)};
}

// Every index of a step is fixed per thread before the chain (the panel
// loop divides nothing): copies of bs-wide boxes (tiles, lower strips) give
// a thread one 16- or 4-byte column of every rstep-th row; copies of bs-tall
// boxes (upper bands) give a warp rows and a lane columns; the xp step gives
// `parts` neighbouring lanes one dot product of every groups-th column; the
// update gives a thread a row, its strip row in registers, and every column.
template <bool LOWER>
__global__ void __launch_bounds__(kThreads, 1)
tri_solve_block_kernel(const float* __restrict__ l, long long l_bstride,
                       int ldl, float* __restrict__ x, int P, int K, int kt,
                       int bs, int ch, int nst, bool inv_all, bool slab) {
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const int bs4 = (bs + 3) & ~3, nq4 = bs4 / 4, cs = tile_stride(bs);
  const int np = P / bs, tile = bs * cs;
  const int slot = LOWER ? ch * cs : bs4 * ch;
  float* const inv = sm;
  float* const ring = inv + (inv_all ? np : 1) * tile;
  float* const xp = ring + nst * slot;  // xp[cc * bs4 + j]
  float* const xs = xp + kt * bs4;
  const float* L = l + (size_t)blockIdx.x * l_bstride;
  float* const xb = x + (size_t)blockIdx.x * P * K;
  const int c0 = blockIdx.y * kt, kc = min(kt, K - c0);
  float* const X = slab ? xs : xb + c0;
  const int ldx = slab ? (kc | 1) : K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // copies: 16 bytes where L's address, its row stride and bs allow
  const bool wide =
      ((reinterpret_cast<uintptr_t>(L) | (uintptr_t)ldl * 4 | bs * 4) & 15) ==
      0;
  const int w = wide ? 4 : 1, cw = bs / w, rstep = kThreads / cw;
  const int rb = tid / cw, cb = (tid - rb * cw) * w;
  auto cp = [&](float* dst, const float* src) {
    if (wide)
      cp_async16(dst, src);
    else
      cp_async4(dst, src);
  };
  auto copy_cols = [&](float* dst, int ds, const float* src, int rows) {
    if (rb < rstep)
      for (int i = rb; i < rows; i += rstep)
        cp(dst + i * ds + cb, src + (size_t)i * ldl + cb);
  };
  auto copy_rows = [&](float* dst, int ds, const float* src, int cols) {
    for (int i = warp; i < bs; i += kWarps)
      for (int c = lane * w; c < cols; c += 32 * w)
        cp(dst + i * ds + c, src + (size_t)i * ldl + c);
  };
  // the xp step: parts (a power of two, so a group never straddles a warp)
  int lgp = 3;
  while (lgp > 0 && (bs * kc << lgp) > kThreads) --lgp;
  const int parts = 1 << lgp, part = tid & (parts - 1), og = tid >> lgp;
  const int groups = (kThreads >> lgp) / bs, pj = og % bs, pc = og / bs;
  const int passes = (kc + groups - 1) / groups;
  // xp into the panel's rows of X: row wj of every wstep-th column
  const int wstep = kThreads / bs, wj = tid % bs, wc = tid / bs;

  // zero the pad between bs and bs4 that the 16-byte reads of the update
  // cover: strip columns (lower) or rows (upper), and xp rows
  if (bs4 > bs) {
    const int pad = bs4 - bs;
    for (int e = tid; e < nst * ch * pad; e += kThreads) {
      const int i = e / pad, p = bs + e - i * pad;
      if (LOWER)
        ring[i * cs + p] = 0.f;  // row i of the stacked stages
      else
        ring[(i / ch) * slot + p * ch + i % ch] = 0.f;
    }
    for (int e = tid; e < kt * pad; e += kThreads)
      xp[(e / pad) * bs4 + bs + e % pad] = 0.f;
  }

  // the producer: its step, chunk within it and stage
  int ps = 0, pq = 0, pst = 0;
  auto issue = [&]() {
    if (ps < np - 1) {  // the last step has no strip
      const int lo = (LOWER ? ps : np - 1 - ps) * bs, ext = P - (ps + 1) * bs;
      const int e0 = pq * ch, n = min(ch, ext - e0);
      float* dst = ring + pst * slot;
      if (LOWER)
        copy_cols(dst, cs, L + (size_t)(lo + bs + e0) * ldl + lo, n);
      else
        copy_rows(dst, ch, L + (size_t)lo * ldl + e0, n);
      pst = pst + 1 == nst ? 0 : pst + 1;
      if (++pq * ch >= ext) {
        ++ps;
        pq = 0;
      }
    }
    cp_async_commit();
  };

  if (inv_all) {
    for (int t = 0; t < np; ++t)
      copy_cols(inv + t * tile, cs, L + (size_t)t * bs * (ldl + 1), bs);
    cp_async_commit();
  }
  for (int s = 0; s < nst - 1; ++s) issue();
  if (slab)
    for (int e = tid; e < P * kc; e += kThreads) {
      const int p = e / kc, cc = e - p * kc;
      xs[p * ldx + cc] = xb[(size_t)p * K + c0 + cc];
    }
  if (inv_all) {
    cp_async_wait(nst - 1);  // the tiles' group, ahead of the strips'
    __syncthreads();
    for (int t = warp; t < np; t += kWarps)
      invert<LOWER>(inv + t * tile, cs, bs, lane);
  }
  __syncthreads();

  int cst = 0;  // the consumer's stage
  for (int s = 0; s < np; ++s) {
    const int t = LOWER ? s : np - 1 - s, lo = t * bs;
    const float* it = inv + (inv_all ? t * tile : 0);
    if (!inv_all) {
      copy_cols(inv, cs, L + (size_t)lo * (ldl + 1), bs);
      cp_async_commit();
      cp_async_wait(0);
      __syncthreads();
      if (warp == 0) invert<LOWER>(inv, cs, bs, lane);
      __syncthreads();
    }
    // xp = inv_tt . rhs (lower) or inv_tt^T . rhs (upper)
    for (int pass = 0; pass < passes; ++pass) {
      const int cc = pc + pass * groups;
      const bool on = pc < groups && cc < kc;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;  // four short chains
      if (on) {
        const float* rhs = X + (size_t)lo * ldx + cc;
        int i = part;
        for (; i + 3 * parts < bs; i += 4 * parts) {
          a0 = fmaf(it[i * cs + pj], rhs[(size_t)i * ldx], a0);
          a1 = fmaf(it[(i + parts) * cs + pj],
                    rhs[(size_t)(i + parts) * ldx], a1);
          a2 = fmaf(it[(i + 2 * parts) * cs + pj],
                    rhs[(size_t)(i + 2 * parts) * ldx], a2);
          a3 = fmaf(it[(i + 3 * parts) * cs + pj],
                    rhs[(size_t)(i + 3 * parts) * ldx], a3);
        }
        for (; i < bs; i += parts)
          a0 = fmaf(it[i * cs + pj], rhs[(size_t)i * ldx], a0);
      }
      float sum = (a0 + a1) + (a2 + a3);
      for (int m = parts / 2; m > 0; m /= 2)
        sum += __shfl_xor_sync(kFull, sum, m);
      if (on && part == 0) xp[cc * bs4 + pj] = sum;
    }
    auto put_xp = [&]() {  // the panel's solution into X
      if (wc < wstep)
        for (int cc = wc; cc < kc; cc += wstep)
          X[(size_t)(lo + wj) * ldx + cc] = xp[cc * bs4 + wj];
    };
    const int ext = P - (s + 1) * bs, nq = (ext + ch - 1) / ch;
    if (nq == 0) {
      __syncthreads();
      put_xp();
    }
    for (int q = 0; q < nq; ++q) {
      cp_async_wait(nst - 2);  // this chunk has landed (this thread's part)
      __syncthreads();         // everyone's part; xp written; stage free
      if (q == 0) put_xp();
      const float* S = ring + cst * slot;
      cst = cst + 1 == nst ? 0 : cst + 1;
      const int e0 = q * ch, n = min(ch, ext - e0);
      for (int rr = tid; rr < n; rr += kThreads) {
        float4 a[8];  // this row's strip: L[row, lo:lo+bs]
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (u < nq4)
            a[u] = LOWER ? reinterpret_cast<const float4*>(S + rr * cs)[u]
                         : make_float4(S[(4 * u) * ch + rr],
                                       S[(4 * u + 1) * ch + rr],
                                       S[(4 * u + 2) * ch + rr],
                                       S[(4 * u + 3) * ch + rr]);
        float* xr = X + (size_t)((LOWER ? lo + bs : 0) + e0 + rr) * ldx;
        for (int cc = 0; cc < kc; ++cc) {
          const float4* y = reinterpret_cast<const float4*>(xp + cc * bs4);
          float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);  // four short chains
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (u < nq4) {
              const float4 v = y[u];
              acc.x = fmaf(a[u].x, v.x, acc.x);
              acc.y = fmaf(a[u].y, v.y, acc.y);
              acc.z = fmaf(a[u].z, v.z, acc.z);
              acc.w = fmaf(a[u].w, v.w, acc.w);
            }
          xr[cc] -= (acc.x + acc.y) + (acc.z + acc.w);
        }
      }
      issue();  // into the stage of the chunk before, which all have left
    }
    __syncthreads();
  }
  if (slab)
    for (int e = tid; e < P * kc; e += kThreads) {
      const int p = e / kc, cc = e - p * kc;
      xb[(size_t)p * K + c0 + cc] = xs[p * ldx + cc];
    }
  cp_async_wait(0);
}

template <int G>
void launch_warp(const float* l, long long l_bstride, int ldl, float* x,
                 int B, int P, int K, bool lower, cudaStream_t stream) {
  const long long items = (long long)B * K, per_block = kWarps * (32 / G);
  const unsigned blocks =
      static_cast<unsigned>((items + per_block - 1) / per_block);
  if (lower)
    tri_solve_warp_kernel<G, true>
        <<<blocks, kThreads, 0, stream>>>(l, l_bstride, ldl, x, B, P, K);
  else
    tri_solve_warp_kernel<G, false>
        <<<blocks, kThreads, 0, stream>>>(l, l_bstride, ldl, x, B, P, K);
}

const void* warp_kernel(int P, bool lower) {
  if (P <= 8)
    return lower ? (const void*)tri_solve_warp_kernel<8, true>
                 : (const void*)tri_solve_warp_kernel<8, false>;
  if (P <= 16)
    return lower ? (const void*)tri_solve_warp_kernel<16, true>
                 : (const void*)tri_solve_warp_kernel<16, false>;
  return lower ? (const void*)tri_solve_warp_kernel<32, true>
               : (const void*)tri_solve_warp_kernel<32, false>;
}

const void* block_kernel(bool lower) {
  return lower ? (const void*)tri_solve_block_kernel<true>
               : (const void*)tri_solve_block_kernel<false>;
}

}  // namespace

void launch_tri_solve(const float* l, long long l_bstride, int ldl, float* x,
                      int B, int P, int K, int kt, int bs, bool lower,
                      cudaStream_t stream) {
  if (P <= 32) {
    if (P <= 8)
      launch_warp<8>(l, l_bstride, ldl, x, B, P, K, lower, stream);
    else if (P <= 16)
      launch_warp<16>(l, l_bstride, ldl, x, B, P, K, lower, stream);
    else
      launch_warp<32>(l, l_bstride, ldl, x, B, P, K, lower, stream);
    return;
  }
  const BlockPlan p = plan_block(P, kt, bs, lower);
  if (p.smem > 48 * 1024) {
    cudaFuncSetAttribute(block_kernel(lower),
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(p.smem));
    if (cudaPeekAtLastError() != cudaSuccess) return;
  }
  const dim3 grid(B, (K + kt - 1) / kt);
  if (lower)
    tri_solve_block_kernel<true><<<grid, kThreads, p.smem, stream>>>(
        l, l_bstride, ldl, x, P, K, kt, bs, p.ch, p.nst, p.inv_all, p.slab);
  else
    tri_solve_block_kernel<false><<<grid, kThreads, p.smem, stream>>>(
        l, l_bstride, ldl, x, P, K, kt, bs, p.ch, p.nst, p.inv_all, p.slab);
}

void tri_solve_kernel_info(int P, int kt, int bs, bool lower, int out[8]) {
  cudaFuncAttributes a{};
  if (P <= 32) {
    cudaFuncGetAttributes(&a, warp_kernel(P, lower));
    out[0] = 0;
    out[1] = a.numRegs;
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = static_cast<int>(a.localSizeBytes);
    out[4] = out[5] = out[6] = out[7] = 0;
    return;
  }
  const BlockPlan p = plan_block(P, kt, bs, lower);
  cudaFuncGetAttributes(&a, block_kernel(lower));
  out[0] = 1;
  out[1] = a.numRegs;
  out[2] = static_cast<int>(p.smem + a.sharedSizeBytes);
  out[3] = static_cast<int>(a.localSizeBytes);
  out[4] = p.inv_all;
  out[5] = p.nst;
  out[6] = p.ch;
  out[7] = p.slab;
}
