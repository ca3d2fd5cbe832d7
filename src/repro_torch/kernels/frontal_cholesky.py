"""Port of ``repro/kernels/frontal_cholesky.py``: all six kernels, each a
hand-written CUDA kernel with its plain PyTorch version beside it.

* The per-front tile kernels of ``ops.frontal_factor``: ``chol_tile``,
  ``tri_inv_tile`` and ``matmul_nt`` (``csrc/tile_kernels.cu``). Like the
  TPU kernels they return new tensors; ``matmul_nt`` can also write into a
  given ``out``.
* The batched kernels of the level-scheduled backends:
  ``frontal_factor_batch``, ``extend_add_batch`` and ``tri_solve_batch``
  (``csrc/frontal_factor.cu``, ``csrc/extend_add.cu``,
  ``csrc/tri_solve.cu``). These work in place on the tensor they are given,
  as the TPU kernels' aliased outputs did. The pipelined factor reaches the
  extend-add kernel through ``extend_add_routed``: one launch per
  destination bucket, from an :class:`ExtendAddRouting` uploaded once per
  factorization; ``extend_add_batch`` is the same kernel for one group of
  contributions.

Each wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel (building it at first use) or raises. The
wrappers count their kernel launches in ``<wrapper>.launches``.

The lower triangle of every front and tile is authoritative: the factors
read and write only entries on or below the diagonal, and the substitution
and the tile inverse read only the lower triangle of L.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import on_cuda
from ._build import count_launch, load_kernels

__all__ = ["chol_tile", "chol_tile_plain", "tri_inv_tile",
           "tri_inv_tile_plain", "matmul_nt", "matmul_nt_plain",
           "frontal_factor_batch", "frontal_factor_batch_plain",
           "extend_add_batch", "extend_add_batch_plain", "extend_add_routed",
           "extend_add_routed_plain", "extend_add_routing", "ExtendAddRouting",
           "extend_add_routing_arrays", "ExtendAddLaunch", "EA_MAX_GROUPS",
           "tri_solve_batch", "tri_solve_batch_plain", "MAX_PANEL"]


#: widest tile ``chol_tile`` and ``tri_inv_tile`` take (the kernels' limit)
MAX_TILE = 128
#: widest panel ``frontal_factor_batch`` and ``tri_solve_batch`` take: the
#: kernels' ``kMaxPanel`` (``csrc/kernels.h``); ``ops.pick_block_size`` caps
#: every panel at it, and the wrappers refuse a wider one on every device
MAX_PANEL = 32


def _check_panel(bs: int) -> None:
    if not 1 <= bs <= MAX_PANEL:
        raise ValueError(f"bs must lie in [1, {MAX_PANEL}], got {bs}")


def _check_tile(t: torch.Tensor, name: str) -> int:
    bs = t.shape[0]
    if t.dim() != 2 or t.shape[1] != bs or not 1 <= bs <= MAX_TILE:
        raise ValueError(f"{name} must be a square tile of at most "
                         f"{MAX_TILE} rows, got {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    return bs


# -- chol_tile ---------------------------------------------------------------

def chol_tile_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain version: unblocked right-looking Cholesky of the lower
    triangle of ``a``, column by column as ``_chol_block`` steps."""
    A = torch.tril(a)
    for j in range(A.shape[0]):
        d = torch.sqrt(A[j, j])
        A[j, j] = d
        A[j + 1 :, j] /= d
        col = A[j + 1 :, j]
        A[j + 1 :, j + 1 :] -= torch.tril(torch.outer(col, col))
    return A


def chol_tile(a: torch.Tensor) -> torch.Tensor:
    """Cholesky factor L of one (bs, bs) f32 SPD tile (bs ≤ 128), read from
    its lower triangle only; returns a new tensor with zeros above the
    diagonal. ``a`` may be a strided view with unit column stride, such as a
    diagonal tile of a workspace. A non-positive pivot gives NaN."""
    bs = _check_tile(a, "a")
    if not on_cuda(a):
        return chol_tile_plain(a)
    out = torch.empty((bs, bs), dtype=torch.float32, device=a.device)
    load_kernels().chol_tile(a, out)
    count_launch(chol_tile)
    return out


chol_tile.launches = 0


# -- tri_inv_tile ------------------------------------------------------------

def tri_inv_tile_plain(l: torch.Tensor) -> torch.Tensor:
    """Plain version: ``Y = L⁻¹`` row by row,
    ``y_r = (e_r − L[r, :r] Y[:r]) / L[r, r]``, as ``_tri_inv_block``."""
    L = torch.tril(l)
    Y = torch.zeros_like(L)
    for r in range(L.shape[0]):
        Y[r] = -(L[r, :r] @ Y[:r])
        Y[r, r] += 1.0
        Y[r] /= L[r, r]
    return Y


def tri_inv_tile(l: torch.Tensor) -> torch.Tensor:
    """Inverse of the lower-triangular (bs, bs) f32 tile ``l`` (bs ≤ 128;
    the lower triangle is read); returns a new lower-triangular tensor."""
    bs = _check_tile(l, "l")
    if not on_cuda(l):
        return tri_inv_tile_plain(l)
    out = torch.empty((bs, bs), dtype=torch.float32, device=l.device)
    load_kernels().tri_inv_tile(l, out)
    count_launch(tri_inv_tile)
    return out


tri_inv_tile.launches = 0


# -- matmul_nt ---------------------------------------------------------------

def matmul_nt_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    alpha: float, beta: float) -> torch.Tensor:
    """Plain version: ``beta·c + alpha·a bᵀ`` in f32."""
    return beta * c + alpha * (a @ b.T)


def matmul_nt(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
              alpha: float = 1.0, beta: float = 1.0,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``beta·c + alpha·a bᵀ`` for f32 ``a`` (M, K), ``b`` (N, K) and ``c``
    (M, N), accumulated in f32 (``beta = 0`` still forms ``0·c``). Any of
    them may be a strided view with unit column stride. The result goes to a
    new tensor, or into ``out`` when given: ``out`` may be ``c`` itself (the
    in-place trailing update of ``ops.frontal_factor``) but must not overlap
    ``a`` or ``b``. Returns the result."""
    M, K = a.shape
    N = b.shape[0]
    if b.shape != (N, K) or c.shape != (M, N) or (
            out is not None and out.shape != (M, N)):
        raise ValueError(f"bad shapes a={tuple(a.shape)} b={tuple(b.shape)} "
                         f"c={tuple(c.shape)}")
    if any(t.dtype != torch.float32 for t in (a, b, c)):
        raise TypeError("a, b and c must be float32")
    tensors = (a, b, c) if out is None else (a, b, c, out)
    if not on_cuda(*tensors):
        res = matmul_nt_plain(a, b, c, alpha, beta)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    load_kernels().matmul_nt(a, b, c, out, float(alpha), float(beta))
    count_launch(matmul_nt)
    return out


matmul_nt.launches = 0


# -- frontal_factor_batch ----------------------------------------------------

def frontal_factor_batch_plain(w: torch.Tensor, npiv: int, bs: int
                               ) -> torch.Tensor:
    """Plain version of the blocked right-looking partial Cholesky, in place
    on the (B, M, M) stack ``w``: per panel, the unblocked Cholesky of the
    diagonal tile, the forward substitution ``L21 = W L11⁻ᵀ`` and the
    rank-bs Schur update of the trailing block (both triangles)."""
    M = w.shape[1]
    for lo in range(0, npiv, bs):
        T = torch.tril(w[:, lo : lo + bs, lo : lo + bs])
        for j in range(bs):
            d = torch.sqrt(T[:, j, j])
            T[:, j, j] = d
            T[:, j + 1 :, j] /= d[:, None]
            col = T[:, j + 1 :, j]
            T[:, j + 1 :, j + 1 :] -= torch.tril(col[:, :, None] * col[:, None, :])
        w[:, lo : lo + bs, lo : lo + bs] = T
        if lo + bs == M:
            continue
        X = w[:, lo + bs :, lo : lo + bs]
        for j in range(bs):
            s = (X[:, :, :j] * T[:, j, None, :j]).sum(-1)
            X[:, :, j] = (X[:, :, j] - s) / T[:, j, j, None]
        w[:, lo + bs :, lo + bs :] -= X @ X.transpose(1, 2)
    return w


def frontal_factor_batch(w: torch.Tensor, npiv: int, *, bs: int
                         ) -> torch.Tensor:
    """Partial Cholesky of the leading ``npiv`` columns of every front of
    the (B, M, M) f32 stack ``w``, in place, in panels of ``bs`` (≤ 32,
    ``MAX_PANEL``; a wider one raises ``ValueError`` on every device)
    columns. Leaves L11 (lower; zeros above the diagonal of each diagonal
    tile) and L21 in the pivot columns and the Schur complement in the
    trailing block, lower triangle authoritative. Returns ``w``."""
    _check_panel(bs)
    B, M, M2 = w.shape
    if M != M2 or not 0 < npiv <= M or npiv % bs:
        raise ValueError(f"bad front stack {tuple(w.shape)} for npiv={npiv}, "
                         f"bs={bs}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if not on_cuda(w):
        return frontal_factor_batch_plain(w, npiv, bs)
    load_kernels().frontal_factor(w, npiv, bs)
    count_launch(frontal_factor_batch)
    return w


frontal_factor_batch.launches = 0


# -- extend_add_batch ---------------------------------------------------------

#: source stacks one extend-add launch reads (the kernel's by-value table,
#: ``kEaMaxGroups``); a destination with more takes further launches
EA_MAX_GROUPS = 32
_GROUP_BITS = 5


@dataclasses.dataclass(frozen=True)
class ExtendAddLaunch:
    """One extend-add kernel launch: source groups ``[g0, g1)`` of its
    destination and the routing's destination rows ``[r0, r1)``; ``max_r``
    is its widest row map."""

    g0: int
    g1: int
    r0: int
    r1: int
    max_r: int


@dataclasses.dataclass
class ExtendAddRouting:
    """The extend-add routing of a sequence of destination buckets, as the
    kernel reads it, in one int32 tensor (``data``) of four sections:

    * ``maps``: each contribution's row map, padded with −1 to a multiple
      of 4;
    * ``ent`` (E, 4): per (contribution, U row) pair ``[src << 5 | group,
      map offset, R, i]`` (``group`` the contribution's source group within
      its launch, R the width of its row map, i the U row), grouped by the
      destination row the pair lands on, in contribution order within a
      row;
    * ``rows`` (N + 1, 2): per destination row ``[slot * M + row, its first
      entry]``, and a sentinel ``[0, E]``; rows that receive nothing are
      left out;
    * ``span`` (N,): a row's first and one past its last touched column,
      ``lo | hi << 16``.

    ``launches[d]`` lists destination ``d``'s launches in order; ``meta[d]``
    holds its M, the largest destination slot and each source group's
    largest source slot and row-map width, which the launch checks against
    the stacks."""

    data: torch.Tensor
    sizes: Tuple[int, int, int]    # map ints, E, N
    launches: List[List[ExtendAddLaunch]]
    meta: List[Tuple[int, int, List[int], List[int]]]

    def sections(self) -> Tuple[torch.Tensor, ...]:
        """(maps, ent, rows, span) views of ``data``."""
        nm, E, N = self.sizes
        cut = np.cumsum([0, nm, 4 * E, 2 * (N + 1), N])
        maps, ent, rows, span = (self.data[a:b] for a, b in
                                 zip(cut[:-1], cut[1:]))
        return maps, ent.view(E, 4), rows.view(N + 1, 2), span

    def to(self, device) -> "ExtendAddRouting":
        """The routing on ``device``, in one copy (pinned and asynchronous
        for CUDA)."""
        device = torch.device(device)
        data = (self.data if device.type != "cuda" else
                self.data.pin_memory().to(device, non_blocking=True))
        return dataclasses.replace(self, data=data)


def extend_add_routing(dests) -> ExtendAddRouting:
    """Build the routing of destination buckets ``dests``, each ``(M,
    groups)`` with ``groups`` its source groups in launch order, each
    ``(src, dst, rows)`` as :func:`extend_add_batch` takes them: the
    contributions of a destination are its groups' in order, each group's in
    its own order. See :func:`extend_add_routing_arrays`."""
    cols = ([], [], [], [], [], [], [], [])
    nc = 0
    for d, (_, groups) in enumerate(dests):
        for g, (src, dst, rows) in enumerate(groups):
            rows = np.asarray(rows, dtype=np.int64)
            C, R = rows.shape
            if np.shape(src) != (C,) or np.shape(dst) != (C,):
                raise ValueError("src and dst must have one entry per row map")
            ci, ii = np.nonzero(rows >= 0)
            for col, x in zip(cols, (np.full(C, d), np.full(C, g), src, dst,
                                     np.full(C, R), nc + ci, ii, rows[ci, ii])):
                col.append(np.asarray(x, dtype=np.int64))
            nc += C
    return extend_add_routing_arrays(
        [M for M, _ in dests], [len(groups) for _, groups in dests],
        *(np.concatenate(c) if c else np.zeros(0, np.int64) for c in cols))


def extend_add_routing_arrays(M, ngroups, c_dest, c_group, c_src, c_dst,
                              c_R, e_c, e_i, e_col) -> ExtendAddRouting:
    """Build the routing from flat arrays. Per destination: its front width
    ``M`` and its number of source groups. Per contribution, in routing
    order (destinations ascending, then source groups ascending, then the
    order in which each W entry is to receive its adds): its destination,
    its source group within it, its source and destination slots and its
    row-map width R. Per active (contribution, U row) pair, in contribution
    order: the contribution, the U row and the destination row it maps to.
    Host NumPy, vectorised: every per-group or per-destination figure is a
    reduction over a run of the sorted contributions."""
    M = np.asarray(M, dtype=np.int64)
    ngroups = np.asarray(ngroups, dtype=np.int64)
    nd, C, E = M.size, c_dest.size, e_c.size
    if np.any((M <= 0) | (M >= 65536)):
        raise ValueError("fronts of M < 65,536 only")
    if C and (np.any(np.diff(c_dest * (1 << 32) + c_group) < 0)
              or np.any(c_group >= ngroups[c_dest])
              or min(c_src.min(), c_dst.min()) < 0
              or c_src.max() >= 1 << (31 - _GROUP_BITS)):
        raise ValueError("contributions out of order, or src or dst out of "
                         "range")
    if E and (np.any(np.diff(e_c) < 0) or e_col.min() < 0
              or np.any(e_col >= M[c_dest[e_c]])):
        raise ValueError("entries out of order, or a row map out of range")

    def runs(key):  # the first index of each run of a sorted key
        return (np.flatnonzero(np.r_[True, key[1:] != key[:-1]]) if key.size
                else np.zeros(0, np.int64))

    def run_max(out, key, x):  # out[k] = max of x over the run of key k
        at = runs(key)
        if at.size:
            out[key[at]] = np.maximum.reduceat(x, at)
        return out

    # source groups and launches of each destination
    nl = -(-ngroups // EA_MAX_GROUPS)
    lbase = np.r_[0, np.cumsum(nl)]
    gbase = np.r_[0, np.cumsum(ngroups)]
    c_launch = lbase[c_dest] + c_group // EA_MAX_GROUPS
    c_gid = gbase[c_dest] + c_group
    max_r = run_max(np.zeros(lbase[-1], np.int64), c_launch, c_R)
    smax = run_max(np.full(gbase[-1], -1, np.int64), c_gid, c_src)
    widths = run_max(np.zeros(gbase[-1], np.int64), c_gid, c_R)
    dmax = run_max(np.full(nd, -1, np.int64), c_dest, c_dst)
    # row maps, each padded with -1 to a multiple of 4 ints
    R4 = -(-c_R // 4) * 4
    map_off = np.r_[0, np.cumsum(R4)]
    maps = np.full(map_off[-1], -1, np.int64)
    maps[map_off[e_c] + e_i] = e_col
    # each contribution's first and one past its last destination row
    c_lo = np.full(C, 1 << 16, np.int64)
    c_hi = run_max(np.full(C, -1, np.int64), e_c, e_col) + 1
    at = runs(e_c)
    if at.size:
        c_lo[e_c[at]] = np.minimum.reduceat(e_col, at)
    # destination rows: the entries grouped by (launch, slot * M + row),
    # each row's in contribution order; a launch's rows are keyed from its
    # base
    e_wrow = c_dst[e_c] * M[c_dest[e_c]] + e_col
    base = np.r_[0, np.cumsum(np.repeat((dmax + 1) * M, nl))]
    key = base[c_launch[e_c]] + e_wrow
    order = (np.argsort(key * C + e_c) if base[-1] < (1 << 62) // max(C, 1)
             else np.lexsort((e_c, key)))
    key, e_c, e_i, e_wrow = (x[order] for x in (key, e_c, e_i, e_wrow))
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]]) if E \
        else np.zeros(0, np.int64)
    N = starts.size
    rows = np.zeros((N + 1, 2), np.int64)
    rows[:N, 0] = e_wrow[starts]
    rows[:N, 1] = starts
    rows[N, 1] = E
    # the span of a row fed by several contributions (the kernel reads no
    # other)
    span = np.zeros(N, np.int64)
    multi = np.flatnonzero(np.diff(rows[:, 1]) > 1)
    if multi.size:
        lens = np.diff(rows[:, 1])[multi]
        at = np.cumsum(lens) - lens  # each row's first, compacted
        cm = e_c[np.arange(lens.sum()) + np.repeat(rows[multi, 1] - at, lens)]
        span[multi] = (np.minimum.reduceat(c_lo[cm], at)
                       | np.maximum.reduceat(c_hi[cm], at) << 16)
    bounds = np.searchsorted(c_launch[e_c[starts]], np.arange(lbase[-1] + 1))
    launches, meta = [], []
    for d in range(nd):
        ls = []
        for k in range(lbase[d], lbase[d + 1]):
            g0 = int(k - lbase[d]) * EA_MAX_GROUPS
            ls.append(ExtendAddLaunch(
                g0, min(int(ngroups[d]), g0 + EA_MAX_GROUPS), int(bounds[k]),
                int(bounds[k + 1]), int(max_r[k])))
        launches.append(ls)
        meta.append((int(M[d]), int(dmax[d]),
                     smax[gbase[d] : gbase[d + 1]].tolist(),
                     widths[gbase[d] : gbase[d + 1]].tolist()))
    ent = np.stack([c_src[e_c] << _GROUP_BITS | c_group[e_c] % EA_MAX_GROUPS,
                    map_off[e_c], c_R[e_c], e_i], axis=1)
    data = np.concatenate([maps, ent.ravel(), rows.ravel(), span])
    return ExtendAddRouting(torch.from_numpy(data.astype(np.int32)),
                            (maps.size, E, N), launches, meta)


def extend_add_batch_plain(w: torch.Tensor, u: torch.Tensor, dst, rows, src,
                           off: int = 0) -> torch.Tensor:
    """Plain version: for each contribution ``c`` in order,
    ``w[dst[c]][rows[c], rows[c]] += u[src[c], off:off+R, off:off+R]`` over
    the active (≥ 0) entries of ``rows[c]``. In place on ``w``."""
    R = rows.shape[1]
    for c in range(rows.shape[0]):
        act = rows[c] >= 0
        idx = torch.as_tensor(rows[c][act], dtype=torch.long, device=w.device)
        actt = torch.as_tensor(np.flatnonzero(act), dtype=torch.long,
                               device=w.device)
        U = u[int(src[c]), off : off + R, off : off + R]
        w[int(dst[c]), idx[:, None], idx[None, :]] += U[actt[:, None], actt[None, :]]
    return w


def extend_add_routed_plain(w: torch.Tensor, us, offs, routing:
                            ExtendAddRouting, d: int) -> torch.Tensor:
    """Plain version of :func:`extend_add_routed`: an interpreter of the
    routing. Round k adds the k-th entry of every destination row at once
    (no two of them share a W entry), so every W entry receives its adds in
    the routing's order, as the kernel adds them. In place on ``w``."""
    maps, ent, rows, _ = (t.cpu().numpy().astype(np.int64)
                          for t in routing.sections())
    M = w.shape[1]
    wf = w.view(-1)
    t = lambda x: torch.as_tensor(x, device=w.device)  # noqa: E731
    for ln in routing.launches[d]:
        first = rows[ln.r0 : ln.r1 + 1, 1]
        e = np.arange(first[0], first[-1])
        rank = e - np.repeat(first[:-1], np.diff(first))
        wrow = np.repeat(rows[ln.r0 : ln.r1, 0], np.diff(first))
        src, grp = ent[e, 0] >> _GROUP_BITS, ent[e, 0] & (EA_MAX_GROUPS - 1)
        moff, R, i = ent[e, 1], ent[e, 2], ent[e, 3]
        for k in range(int(rank.max(initial=-1)) + 1):
            for g in np.unique(grp[rank == k]):
                sel = np.flatnonzero((rank == k) & (grp == g))
                j = np.arange(int(R[sel].max()))
                cols = np.where(j < R[sel, None],
                                maps[np.minimum(moff[sel, None] + j,
                                                maps.size - 1)], -1)
                n, jj = np.nonzero(cols >= 0)
                u, off = us[ln.g0 + g], offs[ln.g0 + g]
                vals = u[t(src[sel][n]), t(off + i[sel][n]), t(off + jj)]
                idx = t(wrow[sel][n] * M + cols[n, jj])
                wf[idx] = wf[idx] + vals
    return w


def _check_launch(w: torch.Tensor, us, offs, routing: ExtendAddRouting,
                  d: int) -> None:
    M, dmax, smax, widths = routing.meta[d]
    if w.dim() != 3 or w.shape[1:] != (M, M) or dmax >= w.shape[0]:
        raise ValueError(f"w {tuple(w.shape)} does not fit destination {d} "
                         f"(M = {M}, slots up to {dmax})")
    if w.dtype != torch.float32:
        raise TypeError("w must be float32")
    if len(us) != len(smax) or len(offs) != len(smax):
        raise ValueError(f"destination {d} reads {len(smax)} source stacks, "
                         f"got {len(us)} stacks and {len(offs)} offsets")
    for g, (u, off) in enumerate(zip(us, offs)):
        if u.dtype != torch.float32:
            raise TypeError("every source stack must be float32")
        if (u.dim() != 3 or u.shape[1] != u.shape[2] or smax[g] >= u.shape[0]
                or off < 0 or off + widths[g] > u.shape[1]):
            raise ValueError(f"source stack {g} {tuple(u.shape)} does not "
                             f"fit its contributions")


def extend_add_routed(w: torch.Tensor, us, offs, routing: ExtendAddRouting,
                      d: int) -> torch.Tensor:
    """Extend-add of destination ``d`` of ``routing`` into the (B, M, M)
    stack ``w``, in place: its source groups read their U from the factored
    stacks ``us`` at offsets ``offs`` (``U[c] = us[g][src[c],
    off:off+R, off:off+R]``). One kernel launch per :data:`EA_MAX_GROUPS`
    source groups, none uploading anything: ``routing`` must already be on
    ``w``'s device. Returns ``w``."""
    _check_launch(w, us, offs, routing, d)
    if not on_cuda(w, *us, routing.data):
        return extend_add_routed_plain(w, us, offs, routing, d)
    maps, ent, rows, span = routing.sections()
    ops = load_kernels()
    for ln in routing.launches[d]:
        if ln.r1 > ln.r0:
            ops.extend_add(w, list(us[ln.g0 : ln.g1]),
                           [int(o) for o in offs[ln.g0 : ln.g1]], maps, ent,
                           rows, span, ln.r0, ln.r1, ln.max_r)
            count_launch(extend_add_batch)
    return w


def extend_add_batch(w: torch.Tensor, u: torch.Tensor, dst, rows, *,
                     src=None, off: int = 0) -> torch.Tensor:
    """On-device extend-add, in place on the (B, M, M) f32 stack ``w``:
    ``w[dst[c]][rows[c], rows[c]] += U[c]`` with
    ``U[c] = u[src[c], off:off+R, off:off+R]`` (``src`` defaults to
    ``arange(C)``, so a (C, R, R) ``u`` is the reference's call). ``dst``
    (C,) must be ascending; ``rows`` (C, R) maps U's rows to rows of the
    front, −1 marking inert ones, the active ones distinct. Equal slots
    accumulate in the order of ``dst``. ``dst``, ``rows`` and ``src`` are
    host arrays (numpy). On CUDA: the kernel of :func:`extend_add_routed`
    for one source group, its routing built and uploaded here. Returns
    ``w``."""
    dst = np.asarray(dst, dtype=np.int32)
    rows = np.asarray(rows, dtype=np.int32)
    C, R = rows.shape
    src = (np.arange(C, dtype=np.int32) if src is None
           else np.asarray(src, dtype=np.int32))
    if dst.shape != (C,) or src.shape != (C,):
        raise ValueError("dst and src must have one entry per row map")
    if np.any(np.diff(dst) < 0):
        raise ValueError("dst must be sorted ascending")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError("w and u must be float32")
    if not on_cuda(w, u):
        return extend_add_batch_plain(w, u, dst, rows, src, off)
    routing = extend_add_routing([(w.shape[1], [(src, dst, rows)])])
    return extend_add_routed(w, [u], [off], routing.to(w.device), 0)


extend_add_batch.launches = 0


# -- tri_solve_batch ---------------------------------------------------------

def tri_solve_batch_plain(l: torch.Tensor, x: torch.Tensor, bs: int,
                          lower: bool) -> torch.Tensor:
    """Plain version of the blocked substitution, in place on the
    (B, P, K) ``x``: ``L Y = X`` panel by panel top-down (``lower``) or
    ``Lᵀ Y = X`` bottom-up, reading only the lower triangle of ``l``."""
    L = torch.tril(l)
    P = L.shape[1]
    npanels = P // bs
    for t in (range(npanels) if lower else range(npanels - 1, -1, -1)):
        lo = t * bs
        Ltt = L[:, lo : lo + bs, lo : lo + bs]
        Xp = x[:, lo : lo + bs]
        if lower:
            for j in range(bs):
                s = (Ltt[:, j, :j, None] * Xp[:, :j]).sum(1)
                Xp[:, j] = (Xp[:, j] - s) / Ltt[:, j, j, None]
            x[:, lo + bs :] -= L[:, lo + bs :, lo : lo + bs] @ Xp
        else:
            for j in range(bs - 1, -1, -1):
                s = (Ltt[:, j + 1 :, j, None] * Xp[:, j + 1 :]).sum(1)
                Xp[:, j] = (Xp[:, j] - s) / Ltt[:, j, j, None]
            x[:, :lo] -= L[:, lo : lo + bs, :lo].transpose(1, 2) @ Xp
    return x


def tri_solve_batch(l: torch.Tensor, x: torch.Tensor, *, bs: int,
                    kt: Optional[int] = None, lower: bool = True
                    ) -> torch.Tensor:
    """Batched triangular substitution in place on the contiguous (B, P, K)
    f32 ``x``: ``L Y = X`` (``lower``) or ``Lᵀ Y = X`` with ``l`` (B, P, P),
    which may be a strided view such as ``W[:, :P, :P]`` of a factored stack
    (unit column stride). ``bs`` divides P and is at most 32; ``kt`` (≤ 32,
    default ``min(K, 32)``) is the RHS tile of one block. Returns ``x``."""
    _check_panel(bs)
    B, P, P2 = l.shape
    if P != P2 or x.shape[:2] != (B, P) or x.dim() != 3 or P % bs:
        raise ValueError(f"bad shapes l={tuple(l.shape)} x={tuple(x.shape)} "
                         f"bs={bs}")
    if l.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError("l and x must be float32")
    if not on_cuda(l, x):
        return tri_solve_batch_plain(l, x, bs, lower)
    K = x.shape[2]
    kt = min(32, max(K, 1)) if kt is None else kt
    load_kernels().tri_solve(l, x, bs, kt, lower)
    count_launch(tri_solve_batch)
    return x


tri_solve_batch.launches = 0
