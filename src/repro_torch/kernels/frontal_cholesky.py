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
  as the TPU kernels' aliased outputs did.

Each wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel (building it at first use) or raises. The
wrappers count their kernel launches in ``<wrapper>.launches``.

The lower triangle of every front and tile is authoritative: the factors
read and write only entries on or below the diagonal, and the substitution
and the tile inverse read only the lower triangle of L.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import on_cuda, to_device
from ._build import load_kernels

__all__ = ["chol_tile", "chol_tile_plain", "tri_inv_tile",
           "tri_inv_tile_plain", "matmul_nt", "matmul_nt_plain",
           "frontal_factor_batch", "frontal_factor_batch_plain",
           "extend_add_batch", "extend_add_batch_plain",
           "tri_solve_batch", "tri_solve_batch_plain"]


#: widest tile ``chol_tile`` and ``tri_inv_tile`` take (the kernels' limit)
MAX_TILE = 128


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
    chol_tile.launches += 1
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
    tri_inv_tile.launches += 1
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
    matmul_nt.launches += 1
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
    the (B, M, M) f32 stack ``w``, in place, in panels of ``bs`` (≤ 32)
    columns. Leaves L11 (lower; zeros above the diagonal of each diagonal
    tile) and L21 in the pivot columns and the Schur complement in the
    trailing block, lower triangle authoritative. Returns ``w``."""
    B, M, M2 = w.shape
    if M != M2 or not 0 < npiv <= M or npiv % bs:
        raise ValueError(f"bad front stack {tuple(w.shape)} for npiv={npiv}, "
                         f"bs={bs}")
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if not on_cuda(w):
        return frontal_factor_batch_plain(w, npiv, bs)
    load_kernels().frontal_factor(w, npiv, bs)
    frontal_factor_batch.launches += 1
    return w


frontal_factor_batch.launches = 0


# -- extend_add_batch --------------------------------------------------------

def _segments(dst: np.ndarray) -> tuple:
    """(seg_ptr, seg_dst) of an ascending ``dst``: contributions
    ``seg_ptr[s]:seg_ptr[s+1]`` all go to slot ``seg_dst[s]``."""
    dst = np.asarray(dst, dtype=np.int64)
    if dst.size and np.any(np.diff(dst) < 0):
        raise ValueError("dst must be sorted ascending")
    starts = np.flatnonzero(np.r_[True, dst[1:] != dst[:-1]]) if dst.size \
        else np.zeros(0, np.int64)
    return np.r_[starts, dst.size].astype(np.int32), dst[starts].astype(np.int32)


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


def extend_add_batch(w: torch.Tensor, u: torch.Tensor, dst, rows, *,
                     src=None, off: int = 0) -> torch.Tensor:
    """On-device extend-add, in place on the (B, M, M) f32 stack ``w``:
    ``w[dst[c]][rows[c], rows[c]] += U[c]`` with
    ``U[c] = u[src[c], off:off+R, off:off+R]`` (``src`` defaults to
    ``arange(C)``, so a (C, R, R) ``u`` is the reference's call). ``dst``
    (C,) must be ascending; ``rows`` (C, R) maps U's rows to rows of the
    front, −1 marking inert ones, the active ones distinct. Equal slots
    accumulate in the order of ``dst``. ``dst``, ``rows`` and ``src`` are
    host arrays (numpy). Returns ``w``."""
    dst = np.asarray(dst, dtype=np.int32)
    rows = np.asarray(rows, dtype=np.int32)
    C, R = rows.shape
    src = (np.arange(C, dtype=np.int32) if src is None
           else np.asarray(src, dtype=np.int32))
    if dst.shape != (C,) or src.shape != (C,):
        raise ValueError("dst and src must have one entry per row map")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError("w and u must be float32")
    seg_ptr, seg_dst = _segments(dst)
    if not on_cuda(w, u):
        return extend_add_batch_plain(w, u, dst, rows, src, off)
    meta = to_device(np.concatenate([src, rows.ravel(), seg_ptr, seg_dst]),
                     w.device)
    a, b = C, C + C * R
    load_kernels().extend_add(w, u, off, meta[:a], meta[a:b].view(C, R),
                              meta[b : b + seg_ptr.size],
                              meta[b + seg_ptr.size :])
    extend_add_batch.launches += 1
    return w


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
    tri_solve_batch.launches += 1
    return x


tri_solve_batch.launches = 0
