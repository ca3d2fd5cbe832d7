// PyTorch bindings of the port's CUDA kernels, registered as torch.ops.repro_torch.*.
//
// The only source that includes PyTorch headers (the light torch/library.h
// and c10/cuda ones), so the .cu files compile as plain CUDA. Every op checks
// device, type, shape and layout, launches on PyTorch's current stream, and
// raises through C10_CUDA_KERNEL_LAUNCH_CHECK() if a launch was refused.
#include <ATen/core/Tensor.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <algorithm>
#include <cstdint>
#include <vector>

#include "kernels.h"

namespace {

void check_cuda(const at::Tensor& t, at::ScalarType type, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == type, name, " has dtype ", t.scalar_type(),
              ", want ", type);
}

void check_int_vector(const at::Tensor& t, const at::Tensor& like,
                      const char* name) {
  check_cuda(t, at::kInt, name);
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
  TORCH_CHECK(t.device() == like.device(), name, " is on another device");
}

int as_int(int64_t v, const char* name) {
  TORCH_CHECK(v >= 0 && v <= INT32_MAX, name, " out of range: ", v);
  return static_cast<int>(v);
}

void frontal_factor(at::Tensor& w, int64_t npiv, int64_t bs) {
  check_cuda(w, at::kFloat, "w");
  TORCH_CHECK(w.dim() == 3 && w.size(1) == w.size(2) && w.is_contiguous(),
              "w must be a contiguous (B, M, M) stack");
  const int64_t M = w.size(1);
  TORCH_CHECK(bs >= 1 && bs <= kMaxPanel, "bs must lie in [1, ", kMaxPanel,
              "], got ", bs);
  TORCH_CHECK(npiv > 0 && npiv <= M && npiv % bs == 0,
              "npiv must be a positive multiple of bs and at most M");
  if (w.size(0) == 0) return;
  const c10::cuda::CUDAGuard guard(w.device());
  // each panel's L11^-T, from the diagonal step to the panel step
  at::Tensor xinv = w.new_empty({w.size(0), bs, bs});
  launch_frontal_factor(w.data_ptr<float>(), xinv.data_ptr<float>(),
                        as_int(w.size(0), "B"), as_int(M, "M"),
                        static_cast<int>(npiv), static_cast<int>(bs),
                        c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// One int32 section of an extend-add routing: contiguous, on w's device,
// its storage aligned for the 16-byte (maps, ent) or 8-byte (rows) loads of
// the kernel.
void check_section(const at::Tensor& t, const at::Tensor& w, int64_t cols,
                   int64_t align, const char* name) {
  check_int_vector(t, w, name);
  TORCH_CHECK(t.dim() == (cols == 1 ? 1 : 2) &&
                  (cols == 1 || t.size(1) == cols),
              name, " must be a (n, ", cols, ") int32 section");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(t.data_ptr()) % align == 0, name,
              " must start at a multiple of ", align, " bytes");
}

// Destination rows [r0, r1) of the routing (maps, ent, rows, span)
// into the (B, M, M) stack w, reading U from the source stacks u[g] at
// offsets off[g] (frontal_cholesky.py `extend_add_routed`).
void extend_add(at::Tensor& w, at::TensorList u, at::IntArrayRef off,
                const at::Tensor& maps,
                const at::Tensor& ent, const at::Tensor& rows,
                const at::Tensor& span, int64_t r0, int64_t r1,
                int64_t max_r) {
  check_cuda(w, at::kFloat, "w");
  TORCH_CHECK(w.dim() == 3 && w.size(1) == w.size(2) && w.is_contiguous(),
              "w must be a contiguous (B, M, M) stack");
  const int64_t M = w.size(1);
  TORCH_CHECK(M < 65536, "extend_add takes fronts of M < 65,536, got ", M);
  TORCH_CHECK(w.size(0) * M <= INT32_MAX, "too many rows in w");
  TORCH_CHECK(!u.empty() && u.size() <= kEaMaxGroups &&
                  static_cast<int64_t>(u.size()) ==
                      static_cast<int64_t>(off.size()),
              "one to ", kEaMaxGroups, " source stacks, each with an offset");
  EaTable tab{};
  tab.n = static_cast<int>(u.size());
  for (size_t g = 0; g < u.size(); ++g) {
    const at::Tensor& s = u[g];
    check_cuda(s, at::kFloat, "u");
    TORCH_CHECK(s.dim() == 3 && s.size(1) == s.size(2) && s.is_contiguous(),
                "each u must be a contiguous (Bu, Mu, Mu) stack");
    TORCH_CHECK(s.device() == w.device(), "u is on another device");
    TORCH_CHECK(off[g] >= 0 && off[g] <= s.size(1), "offset out of range");
    tab.g[g] = EaGroup{s.data_ptr<float>(), as_int(s.size(1), "Mu"),
                       static_cast<int>(off[g])};
  }
  check_section(maps, w, 1, 16, "maps");
  check_section(ent, w, 4, 16, "ent");
  check_section(rows, w, 2, 8, "rows");
  check_section(span, w, 1, 4, "span");
  TORCH_CHECK(0 <= r0 && r0 <= r1 && r1 <= span.size(0) &&
                  span.size(0) + 1 == rows.size(0),
              "rows [r0, r1) out of range");
  TORCH_CHECK(max_r >= 0 && max_r <= INT32_MAX, "max_r out of range");
  if (r1 == r0) return;
  const c10::cuda::CUDAGuard guard(w.device());
  launch_extend_add(w.data_ptr<float>(), static_cast<int>(M), tab,
                    maps.data_ptr<int>(),
                    ent.data_ptr<int>(), rows.data_ptr<int>(),
                    reinterpret_cast<const unsigned*>(span.data_ptr<int>()),
                    static_cast<int>(r0), static_cast<int>(r1),
                    static_cast<int>(max_r),
                    c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The extend_add and row_stats kernels' instantiation i and its resources,
// as extend_add_kernel_info and row_stats_kernel_info (kernels.h) list
// them; an empty list past the last.
std::vector<int64_t> extend_add_info(int64_t i) {
  int info[5];
  if (i < 0 || i > INT32_MAX ||
      !extend_add_kernel_info(static_cast<int>(i), info))
    return {};
  return std::vector<int64_t>(info, info + 5);
}

std::vector<int64_t> row_stats_info(int64_t i) {
  int info[5];
  if (i < 0 || i > INT32_MAX || !row_stats_kernel_info(static_cast<int>(i), info))
    return {};
  return std::vector<int64_t>(info, info + 5);
}

void tri_solve(const at::Tensor& l, at::Tensor& x, int64_t bs, int64_t kt,
               bool lower) {
  check_cuda(l, at::kFloat, "l");
  check_cuda(x, at::kFloat, "x");
  TORCH_CHECK(l.device() == x.device(), "l and x are on different devices");
  TORCH_CHECK(l.dim() == 3 && l.size(1) == l.size(2) && l.stride(2) == 1,
              "l must be a (B, P, P) stack with unit column stride");
  TORCH_CHECK(x.dim() == 3 && x.is_contiguous() && x.size(0) == l.size(0) &&
                  x.size(1) == l.size(1),
              "x must be a contiguous (B, P, K) stack matching l");
  const int64_t P = l.size(1), K = x.size(2);
  TORCH_CHECK(bs >= 1 && bs <= kMaxPanel && P % bs == 0,
              "bs must divide P and lie in [1, ", kMaxPanel, "]");
  TORCH_CHECK(kt >= 1 && kt <= 32, "kt must lie in [1, 32], got ", kt);
  TORCH_CHECK(P * kt * sizeof(float) <= 227 * 1024,
              "P x kt slab does not fit in shared memory");
  if (x.numel() == 0) return;
  const c10::cuda::CUDAGuard guard(x.device());
  launch_tri_solve(l.data_ptr<float>(), l.stride(0), as_int(l.stride(1), "ldl"),
                   x.data_ptr<float>(), as_int(x.size(0), "B"),
                   static_cast<int>(P), as_int(K, "K"), static_cast<int>(kt),
                   static_cast<int>(bs), lower,
                   c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The tri_solve kernel picked for (P, kt, bs, lower) and its resources, as
// tri_solve_kernel_info (kernels.h) lists them.
std::vector<int64_t> tri_solve_info(int64_t P, int64_t kt, int64_t bs,
                                    bool lower) {
  TORCH_CHECK(bs >= 1 && bs <= kMaxPanel && P >= bs && P % bs == 0,
              "bs must divide P and lie in [1, ", kMaxPanel, "]");
  TORCH_CHECK(kt >= 1 && kt <= 32, "kt must lie in [1, 32], got ", kt);
  TORCH_CHECK(P * kt * sizeof(float) <= 227 * 1024,
              "P x kt slab does not fit in shared memory");
  int info[8];
  tri_solve_kernel_info(static_cast<int>(P), static_cast<int>(kt),
                        static_cast<int>(bs), lower, info);
  return std::vector<int64_t>(info, info + 8);
}

void bell_spmv(const at::Tensor& blocks, const at::Tensor& idx,
               const at::Tensor& x, at::Tensor& y) {
  const auto type = blocks.scalar_type();
  TORCH_CHECK(type == at::kDouble || type == at::kFloat,
              "blocks must be float64 or float32");
  for (const at::Tensor* t : {&blocks, &x, static_cast<const at::Tensor*>(&y)}) {
    check_cuda(*t, type, "blocks/x/y");
    TORCH_CHECK(t->is_contiguous(), "blocks, x and y must be contiguous");
    TORCH_CHECK(t->device() == blocks.device(), "tensors on different devices");
  }
  check_int_vector(idx, blocks, "idx");
  TORCH_CHECK(blocks.dim() == 4 && blocks.size(2) == blocks.size(3),
              "blocks must be (nrb, max_k, bs, bs)");
  const int64_t nrb = blocks.size(0), max_k = blocks.size(1),
                bs = blocks.size(2);
  TORCH_CHECK(idx.dim() == 2 && idx.size(0) == nrb && idx.size(1) == max_k,
              "idx must be (nrb, max_k)");
  TORCH_CHECK(x.dim() == 2 && x.size(0) == nrb * bs && y.sizes() == x.sizes(),
              "x and y must be (nrb * bs, k)");
  if (y.numel() == 0) return;
  const c10::cuda::CUDAGuard guard(y.device());
  const auto stream = c10::cuda::getCurrentCUDAStream();
  const int a = as_int(nrb, "nrb"), b = as_int(max_k, "max_k"),
            c = static_cast<int>(bs), d = as_int(x.size(1), "k");
  if (type == at::kDouble)
    launch_bell_spmv_f64(blocks.data_ptr<double>(), idx.data_ptr<int>(),
                         x.data_ptr<double>(), y.data_ptr<double>(), a, b, c, d,
                         stream);
  else
    launch_bell_spmv_f32(blocks.data_ptr<float>(), idx.data_ptr<int>(),
                         x.data_ptr<float>(), y.data_ptr<float>(), a, b, c, d,
                         stream);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The bell_spmv kernel picked for (bs, k, dtype) and its resources, as
// bell_spmv_kernel_info (kernels.h) lists them.
std::vector<int64_t> bell_spmv_info(int64_t bs, int64_t k, bool fp64,
                                    int64_t max_k) {
  TORCH_CHECK(bs >= 1 && k >= 1, "bs and k must be positive");
  int info[5];
  bell_spmv_kernel_info(as_int(bs, "bs"), as_int(k, "k"), fp64,
                        as_int(max_k, "max_k"), info);
  return std::vector<int64_t>(info, info + 5);
}

void check_batch(const at::Tensor& t, at::ScalarType type,
                 const at::Tensor& like, const char* name) {
  check_cuda(t, type, name);
  TORCH_CHECK(t.dim() == 2 && t.is_contiguous(), name,
              " must be a contiguous (B, len) batch");
  TORCH_CHECK(t.sizes() == like.sizes(), name, " has shape ", t.sizes(),
              ", want ", like.sizes());
  TORCH_CHECK(t.device() == like.device(), name, " is on another device");
}

// Partial buffers of a (B, len) reduction in chunks of `chunk`.
void check_parts(const at::Tensor& t, at::ScalarType type, int64_t B,
                 int64_t chunks, const at::Tensor& like, const char* name) {
  check_cuda(t, type, name);
  TORCH_CHECK(t.is_contiguous() && t.dim() == 2 && t.size(0) == B &&
                  t.size(1) == chunks,
              name, " must be a contiguous (B, ", chunks, ") buffer");
  TORCH_CHECK(t.device() == like.device(), name, " is on another device");
}

void check_out(const at::Tensor& t, int64_t B, int64_t k,
               const at::Tensor& like) {
  check_cuda(t, at::kFloat, "out");
  TORCH_CHECK(t.is_contiguous() && t.dim() == 2 && t.size(0) == B &&
                  t.size(1) == k,
              "out must be a contiguous (B, ", k, ") float32 tensor");
  TORCH_CHECK(t.device() == like.device(), "out is on another device");
}

void entry_stats(const at::Tensor& rows, const at::Tensor& cols,
                 const at::Tensor& valid, const at::Tensor& first,
                 int64_t chunk, at::Tensor& bw_part, at::Tensor& prof_part,
                 at::Tensor& out) {
  check_batch(rows, at::kInt, rows, "rows");
  check_batch(cols, at::kInt, rows, "cols");
  check_batch(valid, at::kInt, rows, "valid");
  check_batch(first, at::kInt, rows, "first");
  const int64_t B = rows.size(0), E = rows.size(1);
  TORCH_CHECK(chunk >= 1 && chunk <= INT32_MAX, "chunk out of range");
  TORCH_CHECK(B <= 65535, "at most 65,535 matrices in a batch, got ", B);
  check_parts(bw_part, at::kInt, B, (E + chunk - 1) / chunk, rows, "bw_part");
  check_parts(prof_part, at::kLong, B, (E + chunk - 1) / chunk, rows,
              "prof_part");
  check_out(out, B, 2, rows);
  if (B == 0) return;
  const c10::cuda::CUDAGuard guard(rows.device());
  launch_entry_stats(rows.data_ptr<int>(), cols.data_ptr<int>(),
                     valid.data_ptr<int>(), first.data_ptr<int>(),
                     static_cast<int>(B), as_int(E, "E"),
                     static_cast<int>(chunk), bw_part.data_ptr<int>(),
                     prof_part.data_ptr<int64_t>(), out.data_ptr<float>(),
                     c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void row_stats(const at::Tensor& row_nnz, const at::Tensor& row_valid,
               const at::Tensor& mean, int64_t chunk, at::Tensor& mx_part,
               at::Tensor& mn_part, at::Tensor& sq_part, at::Tensor& arrived,
               at::Tensor& out) {
  check_batch(row_nnz, at::kInt, row_nnz, "row_nnz");
  check_batch(row_valid, at::kInt, row_nnz, "row_valid");
  const int64_t B = row_nnz.size(0), N = row_nnz.size(1);
  check_cuda(mean, at::kFloat, "mean");
  TORCH_CHECK(mean.dim() == 1 && mean.size(0) == B && mean.is_contiguous(),
              "mean must be a contiguous (B,) float32 tensor");
  TORCH_CHECK(mean.device() == row_nnz.device(), "mean is on another device");
  TORCH_CHECK(chunk >= 4 && chunk <= INT32_MAX && chunk % 4 == 0,
              "chunk must be a positive multiple of 4");
  TORCH_CHECK(B <= 65535, "at most 65,535 matrices in a batch, got ", B);
  const int64_t chunks = std::max<int64_t>(1, (N + chunk - 1) / chunk);
  check_parts(mx_part, at::kInt, B, chunks, row_nnz, "mx_part");
  check_parts(mn_part, at::kInt, B, chunks, row_nnz, "mn_part");
  check_parts(sq_part, at::kDouble, B, chunks, row_nnz, "sq_part");
  check_int_vector(arrived, row_nnz, "arrived");
  TORCH_CHECK(arrived.dim() == 1 && arrived.size(0) >= B,
              "arrived must hold a counter for each matrix");
  check_out(out, B, 3, row_nnz);
  if (B == 0) return;
  const c10::cuda::CUDAGuard guard(row_nnz.device());
  launch_row_stats(row_nnz.data_ptr<int>(), row_valid.data_ptr<int>(),
                   mean.data_ptr<float>(), static_cast<int>(B),
                   as_int(N, "N"), static_cast<int>(chunk),
                   mx_part.data_ptr<int>(), mn_part.data_ptr<int>(),
                   sq_part.data_ptr<double>(),
                   reinterpret_cast<unsigned*>(arrived.data_ptr<int>()),
                   out.data_ptr<float>(), c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// A float32 matrix on `like`'s device with unit column stride; returns its
// row stride.
int check_matrix(const at::Tensor& t, const at::Tensor& like,
                 const char* name) {
  check_cuda(t, at::kFloat, name);
  TORCH_CHECK(t.dim() == 2, name, " must be a matrix");
  TORCH_CHECK(t.device() == like.device(), name, " is on another device");
  TORCH_CHECK(t.size(1) <= 1 || t.stride(1) == 1, name,
              " must have unit column stride");
  TORCH_CHECK(t.size(0) <= 1 || t.stride(0) >= t.size(1), name,
              " has overlapping rows");
  return as_int(t.size(0) <= 1 ? t.size(1) : t.stride(0), "row stride");
}

void check_tile_pair(const at::Tensor& in, const at::Tensor& out) {
  const int64_t bs = in.size(0);
  TORCH_CHECK(in.size(1) == bs && bs >= 1 && bs <= kMaxTile,
              "tile must be square with 1 <= bs <= ", kMaxTile, ", got ",
              in.sizes());
  TORCH_CHECK(out.sizes() == in.sizes() && out.is_contiguous(),
              "out must be a contiguous tile of the input's shape");
}

void chol_tile(const at::Tensor& a, at::Tensor& l) {
  const int lda = check_matrix(a, a, "a");
  check_matrix(l, a, "l");
  check_tile_pair(a, l);
  const c10::cuda::CUDAGuard guard(a.device());
  launch_chol_tile(a.data_ptr<float>(), lda, l.data_ptr<float>(),
                   static_cast<int>(a.size(0)),
                   c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void tri_inv_tile(const at::Tensor& l, at::Tensor& y) {
  const int ldl = check_matrix(l, l, "l");
  check_matrix(y, l, "y");
  check_tile_pair(l, y);
  const c10::cuda::CUDAGuard guard(l.device());
  launch_tri_inv_tile(l.data_ptr<float>(), ldl, y.data_ptr<float>(),
                      static_cast<int>(l.size(0)),
                      c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void matmul_nt(const at::Tensor& a, const at::Tensor& b, const at::Tensor& c,
               at::Tensor& out, double alpha, double beta) {
  const int lda = check_matrix(a, a, "a");
  const int ldb = check_matrix(b, a, "b");
  const int ldc = check_matrix(c, a, "c");
  const int ldo = check_matrix(out, a, "out");
  const int64_t M = a.size(0), K = a.size(1), N = b.size(0);
  TORCH_CHECK(b.size(1) == K, "a is ", a.sizes(), " but b is ", b.sizes());
  TORCH_CHECK(c.size(0) == M && c.size(1) == N && out.sizes() == c.sizes(),
              "c and out must be (", M, ", ", N, ")");
  TORCH_CHECK(((M + 15) / 16) * ((N + 15) / 16) <= INT32_MAX,
              "too many output tiles: (", M, ", ", N, ")");
  if (M == 0 || N == 0) return;
  const c10::cuda::CUDAGuard guard(a.device());
  launch_matmul_nt(a.data_ptr<float>(), lda, b.data_ptr<float>(), ldb,
                   c.data_ptr<float>(), ldc, out.data_ptr<float>(), ldo,
                   as_int(M, "M"), as_int(N, "N"), as_int(K, "K"),
                   static_cast<float>(alpha), static_cast<float>(beta),
                   c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The tile kernels' instantiation i and its resources, as tile_kernel_info
// (kernels.h) lists them; an empty list past the last.
std::vector<int64_t> tile_kernels_info(int64_t i) {
  int info[8];
  if (i < 0 || i > INT32_MAX || !tile_kernel_info(static_cast<int>(i), info))
    return {};
  return std::vector<int64_t>(info, info + 8);
}

// The frontal_factor kernels' instantiation i and its resources, as
// frontal_factor_kernel_info (kernels.h) lists them; an empty list past the
// last.
std::vector<int64_t> frontal_factor_info(int64_t i) {
  int info[8];
  if (i < 0 || i > INT32_MAX ||
      !frontal_factor_kernel_info(static_cast<int>(i), info))
    return {};
  return std::vector<int64_t>(info, info + 8);
}

// matmul_nt's output tile and tile counts at (M, N), as matmul_nt_plan
// (kernels.h) gives them.
std::vector<int64_t> matmul_nt_plan_info(int64_t M, int64_t N) {
  TORCH_CHECK(M >= 1 && N >= 1 && M <= INT32_MAX && N <= INT32_MAX,
              "M and N must lie in [1, 2^31), got ", M, ", ", N);
  int plan[4];
  matmul_nt_plan(static_cast<int>(M), static_cast<int>(N), plan);
  return std::vector<int64_t>(plan, plan + 4);
}

// A (B, H, S, D) operand of flash_attention: on `like`'s device with its
// dtype and a unit stride along D. The rest of the layout rule (16-byte
// strides and storage) is the wrapper's (`operand_error` in
// flash_attention.py); on the bf16 path TMA's tensor-map encode enforces it
// too and the launch raises.
void check_attention_operand(const at::Tensor& t, const at::Tensor& like,
                             const char* name) {
  check_cuda(t, like.scalar_type(), name);
  TORCH_CHECK(t.dim() == 4, name, " must be (B, H, S, D)");
  TORCH_CHECK(t.device() == like.device(), name, " is on another device");
  TORCH_CHECK(t.stride(3) == 1, name, " must have unit stride along D");
}

void attention_strides(const at::Tensor& t, long long& sb, long long& sh,
                       long long& ss) {
  sb = t.stride(0);
  sh = t.stride(1);
  ss = t.stride(2);
}

// The forward's checks and parameters: q, k, v, o as flash_attention takes
// them (training's statistics left out).
FlashParams attention_params(const at::Tensor& q, const at::Tensor& k,
                             const at::Tensor& v, const at::Tensor& o,
                             bool causal, double sm_scale, int64_t kv_len) {
  const auto type = q.scalar_type();
  TORCH_CHECK(type == at::kFloat || type == at::kBFloat16,
              "q must be float32 or bfloat16, got ", type);
  for (const at::Tensor* t : {&q, &k, &v, &o})
    check_attention_operand(*t, q, "q/k/v/o");
  const int64_t B = q.size(0), Hq = q.size(1), Sq = q.size(2), D = q.size(3);
  const int64_t Hkv = k.size(1), Skv = k.size(2);
  TORCH_CHECK(D == 16 || D == 32 || D == 64 || D == 128,
              "head dim must be 16, 32, 64 or 128, got ", D);
  TORCH_CHECK(k.sizes() == v.sizes() && k.size(0) == B && k.size(3) == D,
              "k and v must be (B, Hkv, Skv, D) matching q");
  TORCH_CHECK(Hkv > 0 && Hq % Hkv == 0, "Hq must be a multiple of Hkv");
  TORCH_CHECK(o.sizes() == q.sizes(), "o must have q's shape");
  TORCH_CHECK(B <= 65535 && Hq <= 65535, "too many batches or heads");
  FlashParams p{};
  p.q = q.data_ptr();
  p.k = k.data_ptr();
  p.v = v.data_ptr();
  p.o = o.data_ptr();
  p.B = static_cast<int>(B);
  p.Hq = static_cast<int>(Hq);
  p.Hkv = static_cast<int>(Hkv);
  p.Sq = as_int(Sq, "Sq");
  p.Skv = as_int(Skv, "Skv");
  p.D = static_cast<int>(D);
  p.kv_end = kv_len < 0 ? p.Skv : static_cast<int>(std::min(kv_len, Skv));
  p.causal = causal;
  p.scale = static_cast<float>(sm_scale);
  attention_strides(q, p.q_sb, p.q_sh, p.q_ss);
  attention_strides(k, p.k_sb, p.k_sh, p.k_ss);
  attention_strides(v, p.v_sb, p.v_sh, p.v_ss);
  attention_strides(o, p.o_sb, p.o_sh, p.o_ss);
  return p;
}

void flash_attention(const at::Tensor& q, const at::Tensor& k,
                     const at::Tensor& v, at::Tensor& o, bool causal,
                     double sm_scale, int64_t kv_len) {
  const FlashParams p = attention_params(q, k, v, o, causal, sm_scale, kv_len);
  if (p.B == 0 || p.Hq == 0 || p.Sq == 0) return;
  const c10::cuda::CUDAGuard guard(q.device());
  const char* err = launch_flash_attention(
      p, q.scalar_type() == at::kBFloat16, c10::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == nullptr, err);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Training's row statistics beside a (B, Hq, S, D) bf16 operand: a float32
// (B, Hq, ld) contiguous tensor on its device, ld a multiple of 128 of at
// least S (flash_attention.py `lse_rows`), on 16-byte aligned storage.
int64_t check_stats_rows(const at::Tensor& lse, const at::Tensor& q,
                         const char* name) {
  check_cuda(lse, at::kFloat, name);
  TORCH_CHECK(lse.device() == q.device(), name, " is on another device");
  TORCH_CHECK(lse.dim() == 3 && lse.size(0) == q.size(0) &&
                  lse.size(1) == q.size(1) && lse.is_contiguous(),
              name, " must be a contiguous (B, Hq, ld) float32 tensor");
  const int64_t ld = lse.size(2);
  TORCH_CHECK(ld % 128 == 0 && ld >= q.size(2), name, "'s rows of ", ld,
              " must be a multiple of 128 of at least S = ", q.size(2));
  TORCH_CHECK(reinterpret_cast<uintptr_t>(lse.data_ptr()) % 16 == 0, name,
              " must start on a 16-byte boundary");
  return ld;
}

// The forward that also stores training's statistics (the bf16 wgmma
// kernel at D = 64 or 128): o_lo, the output's bf16 remainder, shaped as
// o; lse, the rows' log-sum-exp (check_stats_rows).
void flash_attention_stats(const at::Tensor& q, const at::Tensor& k,
                           const at::Tensor& v, at::Tensor& o, at::Tensor& o_lo,
                           at::Tensor& lse, bool causal, double sm_scale,
                           int64_t kv_len) {
  FlashParams p = attention_params(q, k, v, o, causal, sm_scale, kv_len);
  TORCH_CHECK(q.scalar_type() == at::kBFloat16 && (p.D == 64 || p.D == 128),
              "the forward stores its statistics for bfloat16 at D = 64 or "
              "128 only");
  check_attention_operand(o_lo, q, "o_lo");
  TORCH_CHECK(o_lo.sizes() == q.sizes(), "o_lo must have q's shape");
  p.lse_ld = check_stats_rows(lse, q, "lse");
  if (p.B == 0 || p.Hq == 0 || p.Sq == 0) return;
  p.o_lo = o_lo.data_ptr();
  p.lse = lse.data_ptr<float>();
  attention_strides(o_lo, p.olo_sb, p.olo_sh, p.olo_ss);
  const c10::cuda::CUDAGuard guard(q.device());
  const char* err =
      launch_flash_wgmma(p, c10::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == nullptr, err);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// Registers per thread, dynamic shared memory per block, local memory per
// thread (spills) and ring stages of the bf16 wgmma kernel at head dim d.
std::vector<int64_t> flash_attention_info(int64_t d) {
  TORCH_CHECK(d == 64 || d == 128, "the wgmma kernel takes D = 64 or 128");
  int info[4];
  flash_wgmma_info(static_cast<int>(d), info);
  return {info[0], info[1], info[2], info[3]};
}

// The backward's checks and parameters: q, o, dout, dq (B, Hq, S, D); k, v,
// dk, dv (B, Hkv, S, D). The wrapper (flash_attention.py
// `flash_attention_bwd`) refuses anything but causal attention with as
// many keys as queries before this.
FlashBwdParams bwd_params(const at::Tensor& q, const at::Tensor& k,
                          const at::Tensor& v, const at::Tensor& o,
                          const at::Tensor& dout, const at::Tensor& dq,
                          const at::Tensor& dk, const at::Tensor& dv,
                          double sm_scale) {
  const auto type = q.scalar_type();
  TORCH_CHECK(type == at::kFloat || type == at::kBFloat16,
              "q must be float32 or bfloat16, got ", type);
  for (const at::Tensor* t : {&q, &k, &v, &o, &dout, &dq, &dk, &dv})
    check_attention_operand(*t, q, "q/k/v/o/dout/dq/dk/dv");
  const int64_t B = q.size(0), Hq = q.size(1), S = q.size(2), D = q.size(3);
  const int64_t Hkv = k.size(1);
  TORCH_CHECK(D == 16 || D == 32 || D == 64 || D == 128,
              "head dim must be 16, 32, 64 or 128, got ", D);
  TORCH_CHECK(k.sizes() == v.sizes() && k.size(0) == B && k.size(2) == S &&
                  k.size(3) == D,
              "k and v must be (B, Hkv, S, D) matching q");
  TORCH_CHECK(Hkv > 0 && Hq % Hkv == 0, "Hq must be a multiple of Hkv");
  TORCH_CHECK(o.sizes() == q.sizes() && dout.sizes() == q.sizes() &&
                  dq.sizes() == q.sizes(),
              "o, dout and dq must have q's shape");
  TORCH_CHECK(dk.sizes() == k.sizes() && dv.sizes() == k.sizes(),
              "dk and dv must have k's shape");
  TORCH_CHECK(B <= 65535 && Hq <= 65535, "too many batches or heads");
  FlashBwdParams p{};
  p.q = q.data_ptr();
  p.k = k.data_ptr();
  p.v = v.data_ptr();
  p.o = o.data_ptr();
  p.dout = dout.data_ptr();
  p.dq = dq.data_ptr();
  p.dk = dk.data_ptr();
  p.dv = dv.data_ptr();
  p.B = static_cast<int>(B);
  p.Hq = static_cast<int>(Hq);
  p.Hkv = static_cast<int>(Hkv);
  p.S = as_int(S, "S");
  p.D = static_cast<int>(D);
  p.scale = static_cast<float>(sm_scale);
  attention_strides(q, p.q_sb, p.q_sh, p.q_ss);
  attention_strides(k, p.k_sb, p.k_sh, p.k_ss);
  attention_strides(v, p.v_sb, p.v_sh, p.v_ss);
  attention_strides(o, p.o_sb, p.o_sh, p.o_ss);
  attention_strides(dout, p.do_sb, p.do_sh, p.do_ss);
  attention_strides(dq, p.dq_sb, p.dq_sh, p.dq_ss);
  attention_strides(dk, p.dk_sb, p.dk_sh, p.dk_ss);
  attention_strides(dv, p.dv_sb, p.dv_sh, p.dv_ss);
  return p;
}

// The first design (flash_attention_bwd.cu): rebuilds the row statistics
// itself, in the float32 (2, B, Hq, S) scratch allocated here.
void flash_attention_bwd(const at::Tensor& q, const at::Tensor& k,
                         const at::Tensor& v, const at::Tensor& o,
                         const at::Tensor& dout, at::Tensor& dq,
                         at::Tensor& dk, at::Tensor& dv, double sm_scale) {
  FlashBwdParams p = bwd_params(q, k, v, o, dout, dq, dk, dv, sm_scale);
  TORCH_CHECK(q.scalar_type() == at::kFloat || p.D <= 32,
              "bfloat16 at D = 64 and 128 runs from the forward's statistics "
              "(flash_attention_bwd_sm90)");
  if (p.B == 0 || p.Hq == 0 || p.S == 0) return;
  const c10::cuda::CUDAGuard guard(q.device());
  at::Tensor stats =
      q.new_empty({2, p.B, p.Hq, p.S}, q.options().dtype(at::kFloat));
  p.lse = stats.data_ptr<float>();
  p.delta = p.lse + static_cast<int64_t>(p.B) * p.Hq * p.S;
  p.lse_ld = p.S;
  launch_flash_attention_bwd(p, q.scalar_type() == at::kBFloat16,
                             c10::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The Hopper design (flash_attention_bwd_sm90.cu), bf16 at D = 64 or 128,
// from the forward's statistics: lse (check_stats_rows) and o_lo, the
// output's bf16 remainder; the rows' D go through a float32 scratch of
// lse's shape allocated here.
void flash_attention_bwd_sm90(const at::Tensor& q, const at::Tensor& k,
                              const at::Tensor& v, const at::Tensor& o,
                              const at::Tensor& o_lo, const at::Tensor& dout,
                              const at::Tensor& lse, at::Tensor& dq,
                              at::Tensor& dk, at::Tensor& dv,
                              double sm_scale) {
  FlashBwdParams p = bwd_params(q, k, v, o, dout, dq, dk, dv, sm_scale);
  TORCH_CHECK(q.scalar_type() == at::kBFloat16 && (p.D == 64 || p.D == 128),
              "the Hopper backward takes bfloat16 at D = 64 or 128 only");
  check_attention_operand(o_lo, q, "o_lo");
  TORCH_CHECK(o_lo.sizes() == q.sizes(), "o_lo must have q's shape");
  p.lse_ld = check_stats_rows(lse, q, "lse");
  if (p.B == 0 || p.Hq == 0 || p.S == 0) return;
  const c10::cuda::CUDAGuard guard(q.device());
  at::Tensor delta = lse.new_empty(lse.sizes());
  p.o_lo = o_lo.data_ptr();
  p.lse = const_cast<float*>(lse.data_ptr<float>());
  p.delta = delta.data_ptr<float>();
  attention_strides(o_lo, p.olo_sb, p.olo_sh, p.olo_ss);
  const char* err =
      launch_flash_bwd_wgmma(p, c10::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == nullptr, err);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The first design's two kernels' resources at head dim d, for the bf16
// (mma.sync, d = 16 or 32) or the float32 kernels: flash_attention_bwd_info
// in kernels.h.
std::vector<int64_t> flash_attention_bwd_info_op(int64_t d, bool bf16) {
  TORCH_CHECK(d == 16 || d == 32 || (!bf16 && (d == 64 || d == 128)),
              "the first design takes bf16 at D = 16 or 32 and float32 at "
              "16, 32, 64 or 128, got D = ", d);
  int info[8];
  flash_attention_bwd_info(static_cast<int>(d), bf16, info);
  return std::vector<int64_t>(info, info + 8);
}

// The Hopper design's two kernels' resources at d = 64 or 128:
// flash_bwd_wgmma_info in kernels.h.
std::vector<int64_t> flash_attention_bwd_sm90_info(int64_t d) {
  TORCH_CHECK(d == 64 || d == 128, "the Hopper backward takes D = 64 or 128");
  int info[8];
  flash_bwd_wgmma_info(static_cast<int>(d), info);
  return std::vector<int64_t>(info, info + 8);
}

}  // namespace

TORCH_LIBRARY(repro_torch, m) {
  m.def("chol_tile(Tensor a, Tensor(a!) l) -> ()", &chol_tile);
  m.def("tri_inv_tile(Tensor l, Tensor(a!) y) -> ()", &tri_inv_tile);
  m.def(
      "matmul_nt(Tensor a, Tensor b, Tensor c, Tensor(a!) out, float alpha, "
      "float beta) -> ()",
      &matmul_nt);
  m.def("tile_kernels_info(int i) -> int[]", &tile_kernels_info);
  m.def("matmul_nt_plan(int M, int N) -> int[]", &matmul_nt_plan_info);
  m.def("frontal_factor(Tensor(a!) w, int npiv, int bs) -> ()",
        &frontal_factor);
  m.def("frontal_factor_info(int i) -> int[]", &frontal_factor_info);
  m.def(
      "extend_add(Tensor(a!) w, Tensor[] u, int[] off, Tensor maps, "
      "Tensor ent, Tensor rows, Tensor span, int r0, int r1, int max_r) "
      "-> ()",
      &extend_add);
  m.def("extend_add_info(int i) -> int[]", &extend_add_info);
  m.def("row_stats_info(int i) -> int[]", &row_stats_info);
  m.def("tri_solve(Tensor l, Tensor(a!) x, int bs, int kt, bool lower) -> ()",
        &tri_solve);
  m.def("tri_solve_info(int P, int kt, int bs, bool lower) -> int[]",
        &tri_solve_info);
  m.def("bell_spmv(Tensor blocks, Tensor idx, Tensor x, Tensor(a!) y) -> ()",
        &bell_spmv);
  m.def("bell_spmv_info(int bs, int k, bool fp64, int max_k) -> int[]",
        &bell_spmv_info);
  m.def(
      "entry_stats(Tensor rows, Tensor cols, Tensor valid, Tensor first, "
      "int chunk, Tensor(a!) bw_part, Tensor(b!) prof_part, Tensor(c!) out) "
      "-> ()",
      &entry_stats);
  m.def(
      "flash_attention(Tensor q, Tensor k, Tensor v, Tensor(a!) o, "
      "bool causal, float sm_scale, int kv_len) -> ()",
      &flash_attention);
  m.def("flash_attention_info(int d) -> int[]", &flash_attention_info);
  m.def(
      "flash_attention_stats(Tensor q, Tensor k, Tensor v, Tensor(a!) o, "
      "Tensor(b!) o_lo, Tensor(c!) lse, bool causal, float sm_scale, "
      "int kv_len) -> ()",
      &flash_attention_stats);
  m.def(
      "flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, "
      "Tensor dout, Tensor(a!) dq, Tensor(b!) dk, Tensor(c!) dv, "
      "float sm_scale) -> ()",
      &flash_attention_bwd);
  m.def("flash_attention_bwd_info(int d, bool bf16) -> int[]",
        &flash_attention_bwd_info_op);
  m.def(
      "flash_attention_bwd_sm90(Tensor q, Tensor k, Tensor v, Tensor o, "
      "Tensor o_lo, Tensor dout, Tensor lse, Tensor(a!) dq, Tensor(b!) dk, "
      "Tensor(c!) dv, float sm_scale) -> ()",
      &flash_attention_bwd_sm90);
  m.def("flash_attention_bwd_sm90_info(int d) -> int[]",
        &flash_attention_bwd_sm90_info);
  m.def(
      "row_stats(Tensor row_nnz, Tensor row_valid, Tensor mean, int chunk, "
      "Tensor(a!) mx_part, Tensor(b!) mn_part, Tensor(c!) sq_part, "
      "Tensor(d!) arrived, Tensor(e!) out) -> ()",
      &row_stats);
}
