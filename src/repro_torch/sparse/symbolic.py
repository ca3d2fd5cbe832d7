"""Copy of ``repro/sparse/symbolic.py``.

Symbolic Cholesky analysis: elimination tree, factor pattern, column counts,
fill-in and factorization FLOPs, all without numeric work.

* ``etree``          — Liu's elimination-tree algorithm with path compression.
* ``postorder``      — DFS postorder of the etree.
* ``column_counts``  — row-subtree traversal (O(|L|)): exact nnz per column
                       of the Cholesky factor.
* ``symbolic_cholesky`` — full factor pattern per column (CSC of L).
* ``supernodes``     — fundamental supernodes + relaxed amalgamation for the
                       multifrontal solver.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .csr import CSRMatrix

__all__ = [
    "etree", "postorder", "column_counts", "fill_in", "cholesky_flops",
    "symbolic_cholesky", "supernodes", "SymbolicFactor",
]


def _lower_rows(a: CSRMatrix):
    """Iterate (i, cols<i) for the strict lower triangle, rows ascending."""
    indptr, indices = a.indptr, a.indices
    for i in range(a.n):
        row = indices[indptr[i] : indptr[i + 1]]
        yield i, row[row < i]


def etree(a: CSRMatrix) -> np.ndarray:
    """Elimination tree of a symmetric matrix (parent[j] = -1 for roots)."""
    n = a.n
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    for i, cols in _lower_rows(a):
        for j in cols:
            j = int(j)
            # Walk up with path compression until reaching i's subtree.
            while j != -1 and j < i:
                nxt = ancestor[j]
                ancestor[j] = i
                if nxt == -1:
                    parent[j] = i
                j = int(nxt)
    return parent


def postorder(parent: np.ndarray) -> np.ndarray:
    """Postorder of the forest given by `parent` (children visited first)."""
    n = parent.shape[0]
    # children lists
    head = np.full(n, -1, dtype=np.int64)
    nxt = np.full(n, -1, dtype=np.int64)
    for v in range(n - 1, -1, -1):
        p = parent[v]
        if p >= 0:
            nxt[v] = head[p]
            head[p] = v
    out = np.empty(n, dtype=np.int64)
    k = 0
    stack: List[int] = []
    for root in range(n):
        if parent[root] != -1:
            continue
        stack.append(root)
        while stack:
            v = stack[-1]
            c = head[v]
            if c == -1:
                stack.pop()
                out[k] = v
                k += 1
            else:
                head[v] = nxt[c]
                stack.append(int(c))
    assert k == n
    return out


def column_counts(a: CSRMatrix, parent: np.ndarray | None = None) -> np.ndarray:
    """nnz of each column of L **including** the diagonal.

    Row-subtree method: the pattern of L's row i is the union of etree paths
    from each j (A_ij ≠ 0, j < i) up toward i. Each first visit of a column
    j on such a path contributes one entry L_ij. O(|L|) total.
    """
    n = a.n
    if parent is None:
        parent = etree(a)
    counts = np.ones(n, dtype=np.int64)  # the diagonal
    mark = np.full(n, -1, dtype=np.int64)
    for i, cols in _lower_rows(a):
        mark[i] = i
        for j in cols:
            j = int(j)
            while j != -1 and mark[j] != i:
                mark[j] = i
                counts[j] += 1
                j = int(parent[j])
    return counts


def fill_in(a: CSRMatrix) -> int:
    """Number of factor entries that are NOT in the lower triangle of A."""
    counts = column_counts(a)
    nnz_lower = sum(cols.size for _, cols in _lower_rows(a)) + a.n
    return int(counts.sum()) - nnz_lower


def cholesky_flops(a: CSRMatrix, counts: np.ndarray | None = None) -> int:
    """Factorization FLOPs: Σ_j (1 sqrt + c_j div + c_j(c_j+1) update),
    with c_j = off-diagonal count of column j."""
    if counts is None:
        counts = column_counts(a)
    c = counts.astype(np.int64) - 1
    return int((1 + c + c * (c + 1)).sum())


@dataclasses.dataclass
class SymbolicFactor:
    parent: np.ndarray          # etree
    counts: np.ndarray          # per-column nnz of L (incl. diagonal)
    Lp: np.ndarray              # CSC indptr of L pattern
    Li: np.ndarray              # CSC row indices of L pattern (diag first)
    flops: int
    fill: int

    @property
    def nnz_L(self) -> int:
        return int(self.Li.shape[0])


def symbolic_cholesky(a: CSRMatrix) -> SymbolicFactor:
    """Full column-wise pattern of L (rows sorted ascending per column)."""
    n = a.n
    parent = etree(a)
    counts = column_counts(a, parent)
    Lp = np.zeros(n + 1, dtype=np.int64)
    Lp[1:] = np.cumsum(counts)
    Li = np.empty(int(Lp[-1]), dtype=np.int64)
    fill_ptr = Lp[:-1].copy()
    # diagonal entries first
    Li[fill_ptr] = np.arange(n)
    fill_ptr += 1
    mark = np.full(n, -1, dtype=np.int64)
    for i, cols in _lower_rows(a):
        mark[i] = i
        for j in cols:
            j = int(j)
            while j != -1 and mark[j] != i:
                mark[j] = i
                Li[fill_ptr[j]] = i
                fill_ptr[j] += 1
                j = int(parent[j])
    # sort rows within each column
    for j in range(n):
        Li[Lp[j] : Lp[j + 1]] = np.sort(Li[Lp[j] : Lp[j + 1]])
    nnz_lower = sum(c.size for _, c in _lower_rows(a)) + n
    fl = cholesky_flops(a, counts)
    return SymbolicFactor(parent, counts, Lp, Li, fl, int(counts.sum()) - nnz_lower)


def supernodes(sym: SymbolicFactor, relax: int = 8,
               max_size: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """Partition columns into supernodes for the multifrontal solver.

    A *fundamental* supernode extends column j to j+1 when parent[j] = j+1
    and count[j] = count[j+1] + 1 (identical pattern below). Relaxed
    amalgamation additionally merges a child whose pattern is "close enough"
    (≤ `relax` extra rows), which trades a little fill for far fewer fronts —
    exactly MUMPS's amalgamation knob.

    Returns (snode_ptr, snode_of): snode_ptr[k]..snode_ptr[k+1] are the
    columns of supernode k (contiguous), snode_of[j] = k.
    """
    n = sym.parent.shape[0]
    if n == 0:
        return np.zeros(1, dtype=np.int64), np.empty(0, dtype=np.int64)
    Lp, Li = sym.Lp, sym.Li
    starts = [0]
    # Cumulative amalgamation state for the open supernode: the dense front
    # treats every pivot column as having the union pattern, so we merge only
    # while the *explicit zeros* this padding introduces stay a small
    # fraction of the true entries (CHOLMOD-style relaxed supernodes).
    true_sum = int(sym.counts[0])   # true factor entries in the open snode
    carried = 0                     # union rows not in the newest pattern
    for j in range(1, n):
        s = starts[-1]
        q = j - s  # columns already in the open snode
        new_snode = True
        if sym.parent[j - 1] == j and q < max_size:
            pat_prev = Li[Lp[j - 1] : Lp[j]]
            pat_j = Li[Lp[j] : Lp[j + 1]]
            extra = int(np.setdiff1d(pat_prev[1:], pat_j,
                                     assume_unique=True).size)
            if extra <= relax:
                u = int(sym.counts[j]) + carried + extra  # union size below j
                width = q + u
                dense = (q + 1) * width - q * (q + 1) // 2
                t_sum = true_sum + int(sym.counts[j])
                if dense - t_sum <= max(64, int(0.25 * t_sum)):
                    new_snode = False
                    true_sum = t_sum
                    carried += extra
        if new_snode:
            starts.append(j)
            true_sum = int(sym.counts[j])
            carried = 0
    snode_ptr = np.array(starts + [n], dtype=np.int64)
    snode_of = np.empty(n, dtype=np.int64)
    for k in range(snode_ptr.size - 1):
        snode_of[snode_ptr[k] : snode_ptr[k + 1]] = k
    return snode_ptr, snode_of
