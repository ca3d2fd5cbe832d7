// On-device extend-add: W[dst[c]][rows[c], rows[c]] += U[c], in place, for
// every contribution c of one destination bucket in one launch.
//
// Replaces: repro/kernels/frontal_cholesky.py `extend_add_batch`
//   (pallas_call at :280; body `_extend_add_kernel` :227).
//
// U[c] is read straight out of a source bucket's factored stack:
// U[c] = u_g[src[c], off_g:off_g+R, off_g:off_g+R] for c's source group g,
// so the trailing (Schur) block of a factored front feeds its parent without
// a gather copy. A launch reads up to kEaMaxGroups source stacks, passed by
// value (EaTable): the stacks exist only once their buckets are factored,
// so their pointers cannot be part of a routing uploaded ahead. Row-map
// entries of -1 are inert; the active entries of one row map are distinct.
//
// The routing (frontal_cholesky.py `ExtendAddRouting`) is built on the host
// from the schedule alone and uploaded once per factorization. For every
// destination (slot, row) that receives anything it lists the (contribution,
// U row) pairs that land on it, in the order of the contributions: source
// groups in order, then ascending destination slot. Rows that receive
// nothing are left out.
//
// What bounds it: bytes, and on the path, latency. Each active U entry is
// read once and each touched W entry is read and written once, with one add
// per entry; over a whole 32^3/nd factorization that is at most 368 MB,
// 0.11 ms at the H100 SXM's 3.35 TB/s. The first design took a launch and a
// routing upload per (destination, source) bucket pair (875 on 32^3/nd)
// and re-scanned every row map in every block, so launches and their
// latency chains, not bytes, made its 5.5 ms of device time a solve (H100
// 80GB HBM3, 700 W).
//
// What the design does about it: one launch per destination bucket, no
// upload of its own. A segment of G lanes (a warp, or 4, 8 or 16 lanes
// where the row maps are short) owns one destination row and walks its
// ordered list, so no two segments ever touch the same W entry; where a
// launch has few wide rows (the buckets near the root), up to four warps
// share a row, each taking its own column tiles or column slice:
//   * a row fed by one contribution (87 % of them on 32^3/nd) is added in
//     place, each lane reading U and the row map with 16-byte loads where
//     the stacks allow (scalar loads otherwise) and adding along the mapped
//     columns;
//   * a row fed by several stages the span of columns they touch (its first
//     to its last, in chunks of the segment's buffer) in shared memory, adds
//     the entries in order with a __syncwarp between them, which orders one
//     lane's add before another lane's add to the same entry, and writes the
//     span back once. The U loads do not depend on the buffer, so each lane
//     keeps kInFlight (entry, column tile) loads in flight before it
//     adds.
// There are no float atomics: every W entry starts from its assembled value
// and receives its adds in the routing's order, so the result has the same
// bits on every run and equals the plain version applied group by group.
#include <cstdint>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpBuf = 1536;  // floats of W staging a warp (6 KB)
constexpr int kInFlight = 4;    // (entry, column tile) loads a lane has in
                                // flight before it adds
constexpr int kGroupBits = 5;   // log2(kEaMaxGroups)
// warps a launch of wide rows aims at: 16 on each of the H100's 132 SMs
constexpr int kTargetWarps = 132 * 16;
static_assert(1 << kGroupBits == kEaMaxGroups, "group field width");

// One (contribution, U row) pair of a destination row, decoded.
struct Entry {
  const float* u;   // the U row, at its column 0
  const int* map;   // the contribution's row map
  int R;
};

// e = {src << 5 | group, row-map offset, R, U row}.
__device__ __forceinline__ Entry decode(const EaTable& tab,
                                        const int* __restrict__ maps, int4 e) {
  const EaGroup& g = tab.g[e.x & (kEaMaxGroups - 1)];
  const size_t src = static_cast<unsigned>(e.x) >> kGroupBits;
  const size_t mu = static_cast<size_t>(g.Mu);
  Entry en;
  en.u = g.u + (src * mu + g.off + e.w) * mu + g.off;
  en.map = maps + e.y;
  en.R = e.z;
  return en;
}

// Entry q of the segment's batch: lane q decoded it.
__device__ __forceinline__ Entry bcast(const Entry& mine, int q, int G,
                                       unsigned mask) {
  Entry e;
  e.u = reinterpret_cast<const float*>(
      __shfl_sync(mask, reinterpret_cast<long long>(mine.u), q, G));
  e.map = reinterpret_cast<const int*>(
      __shfl_sync(mask, reinterpret_cast<long long>(mine.map), q, G));
  e.R = __shfl_sync(mask, mine.R, q, G);
  return e;
}

// Adds the batch's ne entries (lane q of the segment decoded entry q, in
// `mine`) to the staged columns [c0, c0 + n) of one W row in `buf`, in
// order. The U and row-map loads of kInFlight (entry, tile) items are all
// in flight before any of them is added; a __syncwarp separates the adds of
// two entries.
template <bool VEC>
__device__ __forceinline__ void add_entries(float* buf, int c0, int n,
                                            const Entry& mine, int ne,
                                            int sl, int G, unsigned mask) {
  constexpr int V = VEC ? 4 : 1;
  const int step = V * G;
  int q = 0, j0 = 0;
  Entry cur = bcast(mine, 0, G, mask);
  while (q < ne) {
    float u[kInFlight][V];
    int m[kInFlight][V];
    int qk[kInFlight];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      qk[k] = q;
      if (q < ne) {  // the same on every lane of the segment
        const int j = j0 + V * sl;
        if constexpr (VEC) {
          const float4 uv = j < cur.R ? __ldg(reinterpret_cast<const float4*>(
                                            cur.u + j))
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
          const int4 mv = j < cur.R ? __ldg(reinterpret_cast<const int4*>(
                                          cur.map + j))
                                    : make_int4(-1, -1, -1, -1);
          u[k][0] = uv.x, u[k][1] = uv.y, u[k][2] = uv.z, u[k][3] = uv.w;
          m[k][0] = mv.x, m[k][1] = mv.y, m[k][2] = mv.z, m[k][3] = mv.w;
        } else {
          u[k][0] = j < cur.R ? __ldg(cur.u + j) : 0.f;
          m[k][0] = j < cur.R ? __ldg(cur.map + j) : -1;
        }
        j0 += step;
        if (j0 >= cur.R) {
          ++q;
          j0 = 0;
          if (q < ne) cur = bcast(mine, q, G, mask);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      if (qk[k] < ne) {
        // the previous entry's adds before this entry's
        if (k > 0 && qk[k] != qk[k - 1]) __syncwarp(mask);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          // an inert -1, or a column of another chunk, falls outside
          // [0, n) as an unsigned offset
          const unsigned x = static_cast<unsigned>(m[k][v] - c0);
          if (x < static_cast<unsigned>(n)) buf[x] += u[k][v];
        }
      }
    }
    __syncwarp(mask);
  }
}

// Grid: a segment of G lanes per destination row r0 + i, i < r1 - r0.
// VEC: 16-byte loads of U, the row maps and W (every stack's Mu and offset,
// M, and the pointers are multiples of 4 floats; each row map starts at a
// multiple of 4 and is padded with -1 to one). P (1 unless G = 32): warps a row. Part p of a row takes column tiles p,
// p + P, ... of a single contribution, or the p-th of P column slices of
// the span of several, so a launch of few wide rows still fills the card.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
extend_add_kernel(float* __restrict__ w, int M,
                  const __grid_constant__ EaTable tab,
                  const int* __restrict__ maps, const int4* __restrict__ ent,
                  const int2* __restrict__ rows,
                  const unsigned* __restrict__ span, int r0, int r1, int G,
                  int P) {
  constexpr int V = VEC ? 4 : 1;
  __shared__ __align__(16) float smem[kWarps * kWarpBuf];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int segs = 32 / G, seg = lane / G, sl = lane - seg * G;
  const int part_id = (blockIdx.x * kWarps + warp) * segs + seg;
  const int row = r0 + part_id / P, part = part_id % P;
  if (row >= r1) return;  // the whole segment leaves together
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (seg * G);
  const int2 rr = __ldg(rows + row);
  const int e0 = rr.y, e1 = __ldg(rows + row + 1).y;
  float* W = w + static_cast<size_t>(rr.x) * M;
  const int step = V * G;

  if (e1 - e0 == 1) {  // one contribution feeds this row: add in place
    const Entry en = decode(tab, maps, __ldg(ent + e0));
#pragma unroll 4
    for (int j = V * sl + part * step; j < en.R; j += step * P) {
      if constexpr (VEC) {
        const float4 u = __ldg(reinterpret_cast<const float4*>(en.u + j));
        const int4 m = __ldg(reinterpret_cast<const int4*>(en.map + j));
        if (m.x >= 0) W[m.x] += u.x;
        if (m.y >= 0) W[m.y] += u.y;
        if (m.z >= 0) W[m.z] += u.z;
        if (m.w >= 0) W[m.w] += u.w;
      } else {
        const int m = __ldg(en.map + j);
        if (m >= 0) W[m] += __ldg(en.u + j);
      }
    }
    return;
  }

  // Several contributions: stage the touched span [lo, hi) in chunks of
  // the segment's buffer, add the entries in order, write the span back.
  // Lane q of the segment decodes entry e0 + q of the first batch of G
  // before the staging, so the two sets of loads overlap.
  const int ne0 = min(G, e1 - e0);
  Entry first{nullptr, nullptr, 0};
  if (sl < ne0) first = decode(tab, maps, __ldg(ent + e0 + sl));
  const unsigned sp = __ldg(span + row);
  const int lo0 = VEC ? static_cast<int>(sp & 0xffffu) & ~3
                      : static_cast<int>(sp & 0xffffu);
  const int hi0 = static_cast<int>(sp >> 16);
  const int slice = ((hi0 - lo0 + P - 1) / P + 3) & ~3;  // this part's
  const int lo = lo0 + part * slice, hi = min(hi0, lo + slice);
  const int cap = kWarpBuf / segs;
  float* buf = smem + warp * kWarpBuf + seg * cap;
  for (int c0 = lo; c0 < hi; c0 += cap) {
    const int n = min(hi - c0, cap);             // columns that take adds
    const int nst = VEC ? (n + 3) & ~3 : n;      // columns staged
    for (int k = V * sl; k < nst; k += step) {
      if constexpr (VEC)
        *reinterpret_cast<float4*>(buf + k) =
            *reinterpret_cast<const float4*>(W + c0 + k);
      else
        buf[k] = W[c0 + k];
    }
    __syncwarp(mask);
    add_entries<VEC>(buf, c0, n, first, ne0, sl, G, mask);
    for (int eb = e0 + G; eb < e1; eb += G) {  // rows of more than G entries
      const int ne = min(G, e1 - eb);
      Entry mine{nullptr, nullptr, 0};
      if (sl < ne) mine = decode(tab, maps, __ldg(ent + eb + sl));
      add_entries<VEC>(buf, c0, n, mine, ne, sl, G, mask);
    }
    for (int k = V * sl; k < nst; k += step) {
      if constexpr (VEC)
        *reinterpret_cast<float4*>(W + c0 + k) =
            *reinterpret_cast<const float4*>(buf + k);
      else
        W[c0 + k] = buf[k];
    }
    __syncwarp(mask);  // the write-back before the next chunk's staging
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Lanes a destination row: the fewest of 4, 8, 16, 32 whose one pass
// covers the launch's widest row map.
int segment_lanes(int max_r, bool vec) {
  int g = 4;
  while (g < 32 && g * (vec ? 4 : 1) < max_r) g *= 2;
  return g;
}

const void* kernel_of(bool vec) {
  return vec ? reinterpret_cast<const void*>(extend_add_kernel<true>)
             : reinterpret_cast<const void*>(extend_add_kernel<false>);
}

}  // namespace

void launch_extend_add(float* w, int M, const EaTable& tab, const int* maps,
                       const int* ent, const int* rows, const unsigned* span,
                       int r0, int r1, int max_r, cudaStream_t stream) {
  if (r1 <= r0) return;
  bool vec = M % 4 == 0 && aligned16(w) && aligned16(maps);
  for (int g = 0; g < tab.n; ++g)
    vec = vec && tab.g[g].Mu % 4 == 0 && tab.g[g].off % 4 == 0 &&
          aligned16(tab.g[g].u);
  const int G = segment_lanes(max_r, vec);
  // warps a row: up to 4, until the launch has kTargetWarps
  int P = 1;
  while (G == 32 && P < 4 && (long long)(r1 - r0) * P < kTargetWarps) P *= 2;
  const int per_block = kWarps * (32 / G);
  const int blocks = ((r1 - r0) * P + per_block - 1) / per_block;
  const auto* ent4 = reinterpret_cast<const int4*>(ent);
  const auto* rows2 = reinterpret_cast<const int2*>(rows);
  if (vec)
    extend_add_kernel<true><<<blocks, kThreads, 0, stream>>>(
        w, M, tab, maps, ent4, rows2, span, r0, r1, G, P);
  else
    extend_add_kernel<false><<<blocks, kThreads, 0, stream>>>(
        w, M, tab, maps, ent4, rows2, span, r0, r1, G, P);
}

int extend_add_kernel_info(int i, int out[5]) {
  if (i < 0 || i > 1) return 0;
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, kernel_of(i == 1));
  out[0] = i;
  out[1] = kThreads;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.sharedSizeBytes);
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 1;
}
