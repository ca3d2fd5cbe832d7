// Host launchers of the port's hand-written CUDA kernels (sm_90a).
//
// Each launcher enqueues its kernel(s) on `stream` and returns without
// synchronising; it allocates nothing. After a failed launch it returns at
// once, leaving the error for the caller's C10_CUDA_KERNEL_LAUNCH_CHECK().
// The binding (bindings.cpp) checks shapes, types and devices first.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// Widest panel the factor and sweep kernels take (pick_block_size caps at 32).
constexpr int kMaxPanel = 32;

// Widest tile chol_tile and tri_inv_tile take (ops.frontal_factor's bs = 128).
constexpr int kMaxTile = 128;

// frontal_factor.cu: `xinv` is a (B, bs, bs) scratch for each panel's
// L11^-T.
void launch_frontal_factor(float* w, float* xinv, int B, int M, int npiv,
                           int bs, cudaStream_t stream);

// Instantiation i of the frontal_factor kernels, while i is below their
// count (returns 0 past it): kind (0 the diagonal step, 1 the panel step,
// 2 the Schur step, 3 the whole-front kernel of M <= 32), three parameters
// (diagonal: the register row's width and warps a front; whole front: the
// largest M and warps a front;
// panel: 0, 0 and whether its copies are 16-byte; Schur: the output tile's
// edge, outputs a thread along it and whether its copies are 16-byte),
// threads a block, registers per thread, shared memory per block at its
// largest (bytes), local memory per thread (bytes: spills).
int frontal_factor_kernel_info(int i, int out[8]);

// extend_add.cu: one launch adds every contribution of destination rows
// [r0, r1) of a routing into the (B, M, M) stack `w` (M < 65,536). Each
// contribution reads its U from one of the tab.n source groups: a factored
// (Bu, Mu, Mu) stack and the offset of its trailing block. The routing's
// arrays (frontal_cholesky.py `ExtendAddRouting`): maps (each contribution's
// row map, padded with -1 to a multiple of 4); ent (4 ints an entry, a
// (contribution, U row) pair: src << 5 | group, row-map offset, R, U row);
// rows (2 ints a destination row and a sentinel: slot * M + row, its first
// entry); span (a destination row's first and one past its last touched
// column, lo | hi << 16). `max_r` is the widest row map of the launch.
constexpr int kEaMaxGroups = 32;

struct EaGroup {
  const float* u;
  int Mu;
  int off;
};

struct EaTable {
  EaGroup g[kEaMaxGroups];
  int n;
};

void launch_extend_add(float* w, int M, const EaTable& tab, const int* maps,
                       const int* ent, const int* rows, const unsigned* span,
                       int r0, int r1, int max_r, cudaStream_t stream);

// Instantiation i of the extend_add kernel, while i is below 2 (returns 0
// past it): whether it loads 16 bytes, threads a block, registers per
// thread, shared memory per block (bytes), local memory per thread (bytes:
// spills).
int extend_add_kernel_info(int i, int out[5]);

void launch_tri_solve(const float* l, long long l_bstride, int ldl, float* x,
                      int B, int P, int K, int kt, int bs, bool lower,
                      cudaStream_t stream);

// The tri_solve kernel that launch_tri_solve picks for (P, kt, bs, lower)
// (tri_solve.cu): variant (0: a segment of lanes per front and column, for
// P <= 32; 1: a block per front and RHS tile), registers per thread, shared
// memory per block (bytes), local memory per thread (bytes: spills), then
// for variant 1 whether every diagonal inverse is made ahead of the chain,
// the ring's stages, its chunk (strip rows or columns) and whether the slab
// sits in shared memory.
void tri_solve_kernel_info(int P, int kt, int bs, bool lower, int out[8]);

void launch_bell_spmv_f64(const double* blocks, const int* idx,
                          const double* x, double* y, int nrb, int max_k,
                          int bs, int kk, cudaStream_t stream);

void launch_bell_spmv_f32(const float* blocks, const int* idx, const float* x,
                          float* y, int nrb, int max_k, int bs, int kk,
                          cudaStream_t stream);

// The bell_spmv kernel that the launchers pick for (bs, kk) in fp64 or fp32
// (spmv_bell.cu): whether it is the segment kernel of bs in {1, 2, 4, 8}
// (1) or the generic one (0), threads a block-row (the segment's lanes G
// at this max_k, or the generic kernel's warp), registers per thread,
// static shared memory per block (bytes), local memory per thread (bytes:
// spills).
void bell_spmv_kernel_info(int bs, int kk, bool fp64, int max_k, int out[5]);

// csr_stats.cu: partial buffers are (B, ceil(len / chunk)); out is (B, 2)
// for entry_stats and (B, 3) for row_stats.
void launch_entry_stats(const int* rows, const int* cols, const int* valid,
                        const int* first, int B, int E, int chunk,
                        int* bw_part, int64_t* prof_part, float* out,
                        cudaStream_t stream);

// row_stats is one kernel: its partial buffers are (B, max(1, ceil(N /
// chunk))), chunk a multiple of 4, and `arrived` (B) holds zeros, which the
// kernel leaves as it found them.
void launch_row_stats(const int* row_nnz, const int* row_valid,
                      const float* mean, int B, int N, int chunk,
                      int* mx_part, int* mn_part, double* sq_part,
                      unsigned* arrived, float* out, cudaStream_t stream);

// Instantiation i of the row_stats kernel, while i is below 2: whether it
// loads 16 bytes, threads a block, registers per thread, shared memory per
// block (bytes), local memory per thread (bytes: spills).
int row_stats_kernel_info(int i, int out[5]);

// tile_kernels.cu: `a`, `l` and the matmul operands are row-major with the
// given row strides (unit column stride); `l` and `y` are contiguous
// (bs, bs) outputs. matmul_nt's `out` may alias `c`, never `a` or `b`.
void launch_chol_tile(const float* a, int lda, float* l, int bs,
                      cudaStream_t stream);

void launch_tri_inv_tile(const float* l, int ldl, float* y, int bs,
                         cudaStream_t stream);

void launch_matmul_nt(const float* a, int lda, const float* b, int ldb,
                      const float* c, int ldc, float* out, int ldo, int M,
                      int N, int K, float alpha, float beta,
                      cudaStream_t stream);

// Instantiation i of the tile kernels (tile_kernels.cu), while i is below
// their count (returns 0 past it): kind (0 chol_tile, 1 tri_inv_tile,
// 2 matmul_nt), three parameters (chol_tile: the widest tile; tri_inv_tile:
// diagonal blocks of 32; matmul_nt: the output tile's rows and columns and
// whether its copies are 16-byte), threads a block, registers per thread,
// shared memory per block at the widest tile (bytes), local memory per
// thread (bytes: spills).
int tile_kernel_info(int i, int out[8]);

// matmul_nt's launch at (M, N): the output tile's rows and columns, then
// the tiles down M and across N (the blocks are their product).
void matmul_nt_plan(int M, int N, int out[4]);

// flash_attention.cu: q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) and o (B, Hq,
// Sq, D), all float32 or all bfloat16, each with a unit stride along D and
// the given element strides of its batch, head and sequence dims (batch,
// head and sequence strides multiples of 16 bytes on 16-byte aligned
// storage: the wrapper's rule, `operand_error` in flash_attention.py). Keys
// at or past kv_end (<= Skv) are masked; causal masks keys past the query's
// index.
//
// Training's statistics (the bf16 kernel at D = 64 and 128 only): where
// o_lo is not null, the kernel also writes o_lo, the output's bf16
// remainder o - bf16(o) (laid out as o, strides olo_*), and lse, the rows'
// natural log-sum-exp as float32 (B, Hq, lse_ld), row (b, h) at (b Hq + h)
// lse_ld, with lse_ld >= Sq rounded up to 128: every row of the grid's last
// query tile is written.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  void* o_lo;
  float* lse;
  int B, Hq, Hkv, Sq, Skv, D, kv_end;
  bool causal;
  float scale;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss, olo_sb, olo_sh, olo_ss, lse_ld;
};

// Returns nullptr, or the reason it launched nothing (a tensor map that
// TMA refuses); a refused launch is left for the caller's check.
const char* launch_flash_attention(const FlashParams& p, bool bf16,
                                   cudaStream_t stream);

// flash_attention_sm90.cu: the bfloat16 kernel at D = 64 and 128.
const char* launch_flash_wgmma(const FlashParams& p, cudaStream_t stream);

// That kernel's registers per thread (as compiled, before setmaxnreg),
// dynamic shared memory per block (bytes), local memory per thread (bytes:
// spills) and ring stages, for D = 64 or 128.
void flash_wgmma_info(int D, int out[4]);

// flash_attention_bwd.cu: the gradient of the causal flash attention with
// Sq == Skv == S. q, o, dout, dq (B, Hq, S, D) and k, v, dk, dv (B, Hkv, S,
// D), all float32 or all bfloat16, each with a unit stride along D and the
// given element strides of its batch, head and sequence dims (the forward's
// layout rule); lse and delta a float32 (B, Hq, S) contiguous scratch that
// the first launch writes and the second reads (lse_ld = S).
//
// flash_attention_bwd_sm90.cu (bf16, D = 64 and 128) reads lse, the
// forward's log-sum-exp, and o_lo, its output's bf16 remainder (strides
// olo_*), and writes delta; both float32 (B, Hq, lse_ld), lse_ld a multiple
// of 128 at least S, on 16-byte aligned storage.
struct FlashBwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* o_lo;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;
  float* delta;
  int B, Hq, Hkv, S, D;
  float scale;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss, olo_sb, olo_sh, olo_ss, do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss,
      dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss, lse_ld;
};

// Two launches: dQ with the row statistics, then dK and dV. `bf16` picks
// the mma.sync kernels (bfloat16 operands, D = 16 or 32), else the float32
// ones.
void launch_flash_attention_bwd(const FlashBwdParams& p, bool bf16,
                                cudaStream_t stream);

// Registers per thread, shared memory per block (bytes), local memory per
// thread (bytes: spills) and threads a block of the dQ kernel, then the same
// four of the dK/dV kernel, at head dim D (bf16: 16 or 32; float32: 16,
// 32, 64 or 128).
void flash_attention_bwd_info(int D, bool bf16, int out[8]);

// flash_attention_bwd_sm90.cu: the bf16 backward at D = 64 or 128 from the
// forward's statistics, two launches: dQ with each row's D = sum dO (o +
// o_lo) into delta, then dK and dV. Returns nullptr, or the reason it
// launched nothing (a tensor map that TMA refuses); a refused launch is
// left for the caller's check.
const char* launch_flash_bwd_wgmma(const FlashBwdParams& p,
                                   cudaStream_t stream);

// Registers per thread (as compiled, before setmaxnreg), dynamic shared
// memory per block (bytes), local memory per thread (bytes: spills) and
// ring stages of the dQ kernel, then the same four of the dK/dV kernel, at
// D = 64 or 128.
void flash_bwd_wgmma_info(int D, int out[8]);
