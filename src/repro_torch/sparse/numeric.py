"""Copy of ``repro/sparse/numeric.py``: the simplicial and skyline solvers,
host NumPy in fp64 (``sparse_cholesky`` :40, ``cholesky_solve`` :95,
``skyline_cholesky`` :126, ``skyline_solve`` :171).

Two simplicial solvers live here; the production path is the multifrontal
solver in :mod:`repro_torch.sparse.multifrontal`. ``execute_plan`` runs
:func:`sparse_cholesky` and :func:`cholesky_solve` for
``solver="simplicial"``.

* :func:`sparse_cholesky` — up-looking simplicial Cholesky on the exact
  symbolic pattern. O(FLOPs) but Python-loop bound; used as the correctness
  oracle for the multifrontal solver and for small systems.
* :func:`skyline_cholesky` — envelope (profile) Cholesky: stores each row
  from its first nonzero to the diagonal densely. Its cost is
  Σ_i w_i² where w_i is the row envelope width — the solver family for which
  RCM-style bandwidth/profile reduction is the right objective.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .csr import CSRMatrix
from .symbolic import SymbolicFactor, symbolic_cholesky

__all__ = [
    "sparse_cholesky", "cholesky_solve", "SparseCholesky",
    "skyline_cholesky", "skyline_solve", "SkylineFactor",
]


# ---------------------------------------------------------------------------
# Simplicial sparse Cholesky (up-looking, CSC factor)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SparseCholesky:
    sym: SymbolicFactor
    Lx: np.ndarray  # values aligned with sym.Li / sym.Lp (CSC, diag first-by-sort)


def sparse_cholesky(a: CSRMatrix, sym: SymbolicFactor | None = None) -> SparseCholesky:
    """Left-looking numeric factorization on the precomputed pattern.

    ``sym`` may come from a cached :class:`repro_torch.core.plan.ExecutionPlan`
    (valid for any matrix with the plan's structure fingerprint), in which
    case no symbolic analysis runs here — straight to numeric work.

    For column j:  L[j:,j] = (A[j:,j] − Σ_{k<j, L_jk≠0} L_jk · L[j:,k]) / L_jj
    The set {k : L_jk ≠ 0} is exactly the nonzeros of row j of L, which we
    accumulate with per-row lists as columns complete.
    """
    if sym is None:
        sym = symbolic_cholesky(a)
    n = a.n
    Lp, Li = sym.Lp, sym.Li
    Lx = np.zeros(Li.shape[0], dtype=np.float64)
    # position of row i within column j for scatter: use a dense work vector
    work = np.zeros(n, dtype=np.float64)
    # rows_of[j] = list of (k, idx into column k where row j sits)
    row_entries: list[list[Tuple[int, int]]] = [[] for _ in range(n)]

    indptr, indices, data = a.indptr, a.indices, a.data
    if data is None:
        raise ValueError("numeric factorization needs values")

    for j in range(n):
        lo, hi = Lp[j], Lp[j + 1]
        pattern = Li[lo:hi]  # sorted ascending, pattern[0] == j
        # scatter A[j:, j] — by symmetry read row j of A, cols >= j
        a_lo, a_hi = indptr[j], indptr[j + 1]
        arow = indices[a_lo:a_hi]
        avals = data[a_lo:a_hi]
        sel = arow >= j
        work[arow[sel]] = avals[sel]
        # gather updates from earlier columns k with L[j,k] != 0
        for (k, idx) in row_entries[j]:
            ljk = Lx[idx]
            klo, khi = idx, Lp[k + 1]  # entries of column k from row j down
            rows_k = Li[klo:khi]
            work[rows_k] -= ljk * Lx[klo:khi]
        dj = work[j]
        if dj <= 0.0:
            raise np.linalg.LinAlgError(
                f"matrix not positive definite at column {j} (d={dj:.3e})")
        dj = np.sqrt(dj)
        colvals = work[pattern]
        colvals[0] = dj
        colvals[1:] /= dj
        Lx[lo:hi] = colvals
        work[pattern] = 0.0
        # register this column in the row lists of its below-diagonal rows
        for t in range(lo + 1, hi):
            row_entries[Li[t]].append((j, t))
    return SparseCholesky(sym, Lx)


def cholesky_solve(f: SparseCholesky, b: np.ndarray) -> np.ndarray:
    """Solve A x = b given A = L Lᵀ."""
    n = f.sym.Lp.shape[0] - 1
    Lp, Li, Lx = f.sym.Lp, f.sym.Li, f.Lx
    x = b.astype(np.float64).copy()
    # forward: L y = b (column-oriented)
    for j in range(n):
        lo, hi = Lp[j], Lp[j + 1]
        x[j] /= Lx[lo]
        if hi > lo + 1:
            x[Li[lo + 1 : hi]] -= Lx[lo + 1 : hi] * x[j]
    # backward: Lᵀ x = y
    for j in range(n - 1, -1, -1):
        lo, hi = Lp[j], Lp[j + 1]
        if hi > lo + 1:
            x[j] -= np.dot(Lx[lo + 1 : hi], x[Li[lo + 1 : hi]])
        x[j] /= Lx[lo]
    return x


# ---------------------------------------------------------------------------
# Skyline / envelope Cholesky
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SkylineFactor:
    first: np.ndarray   # first[i] = column of first stored entry of row i
    rows: list          # rows[i] = dense row i segment first[i]..i of L
    flops: int


def skyline_cholesky(a: CSRMatrix) -> SkylineFactor:
    """Envelope Cholesky: row i of L is dense on [first[i], i].

    Cost Σ w_i² with w_i = i − first[i] + 1: directly minimized by
    profile-reducing orderings (RCM). Vectorized with numpy per row.
    """
    n = a.n
    indptr, indices, data = a.indptr, a.indices, a.data
    if data is None:
        raise ValueError("numeric factorization needs values")
    first = np.empty(n, dtype=np.int64)
    for i in range(n):
        row = indices[indptr[i] : indptr[i + 1]]
        row = row[row <= i]
        first[i] = row[0] if row.size else i
    # skyline must be monotone enough for the algorithm: widen rows so that
    # the needed leading entries of previous rows exist
    rows: list[np.ndarray] = []
    flops = 0
    for i in range(n):
        fi = int(first[i])
        seg = np.zeros(i - fi + 1, dtype=np.float64)
        arow = indices[indptr[i] : indptr[i + 1]]
        avals = data[indptr[i] : indptr[i + 1]]
        sel = (arow >= fi) & (arow <= i)
        seg[arow[sel] - fi] = avals[sel]
        # eliminate against previous rows j in [fi, i)
        for j in range(fi, i):
            fj = int(first[j])
            lo = max(fi, fj)
            # dot(L[i, lo:j], L[j, lo:j])
            li = seg[lo - fi : j - fi]
            lj = rows[j][lo - fj : j - fj]
            s = seg[j - fi] - (li @ lj if li.size else 0.0)
            djj = rows[j][j - fj]
            seg[j - fi] = s / djj
            flops += 2 * li.size + 2
        dii = seg[i - fi] - (seg[: i - fi] @ seg[: i - fi] if i > fi else 0.0)
        if dii <= 0:
            raise np.linalg.LinAlgError(f"not SPD at row {i}")
        seg[i - fi] = np.sqrt(dii)
        flops += 2 * (i - fi) + 2
        rows.append(seg)
    return SkylineFactor(first, rows, flops)


def skyline_solve(f: SkylineFactor, b: np.ndarray) -> np.ndarray:
    n = len(f.rows)
    y = b.astype(np.float64).copy()
    for i in range(n):
        fi = int(f.first[i])
        seg = f.rows[i]
        if i > fi:
            y[i] -= seg[: i - fi] @ y[fi:i]
        y[i] /= seg[i - fi]
    x = y
    for i in range(n - 1, -1, -1):
        fi = int(f.first[i])
        seg = f.rows[i]
        x[i] /= seg[i - fi]
        if i > fi:
            x[fi:i] -= seg[: i - fi] * x[i]
    return x
