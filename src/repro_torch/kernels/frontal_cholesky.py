"""Port of ``repro/kernels/frontal_cholesky.py``: ``frontal_factor_batch``,
``extend_add_batch`` and ``tri_solve_batch``, each a hand-written CUDA
kernel (``csrc/frontal_factor.cu``, ``csrc/extend_add.cu``,
``csrc/tri_solve.cu``) with its plain PyTorch version beside it.

Each wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel (building it at first use) or raises. The
wrappers count their kernel launches in ``<wrapper>.launches``.

All three work in place on the tensor they are given, as the TPU kernels'
aliased outputs did. The lower triangle of every front is authoritative:
the factor reads and writes only entries on or below the diagonal of the
trailing block, and the substitution reads only the lower triangle of L.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import on_cuda, to_device
from ._build import load_kernels

__all__ = ["frontal_factor_batch", "frontal_factor_batch_plain",
           "extend_add_batch", "extend_add_batch_plain",
           "tri_solve_batch", "tri_solve_batch_plain"]


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
