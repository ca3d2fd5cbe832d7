"""Copy of ``repro/sparse/csr.py``: ``CSRMatrix``, ``coo_to_csr``,
``csr_from_dense``, ``bandwidth``, ``profile``, ``permute_symmetric``,
``symmetrize_pattern`` and ``make_spd``.

Compressed-sparse-row container and structural utilities. Host-side
structure manipulation is vectorized numpy (int32 indices); numeric payloads
become torch tensors at the solver boundary
(:mod:`repro_torch.sparse.multifrontal`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "CSRMatrix",
    "coo_to_csr",
    "csr_from_dense",
    "bandwidth",
    "profile",
    "permute_symmetric",
    "symmetrize_pattern",
    "make_spd",
]


@dataclasses.dataclass
class CSRMatrix:
    """Square sparse matrix in CSR format.

    indptr:  (n+1,) int32
    indices: (nnz,) int32 column indices, sorted within each row
    data:    (nnz,) float64 values (may be None for pattern-only matrices)
    """

    indptr: np.ndarray
    indices: np.ndarray
    data: Optional[np.ndarray]
    shape: Tuple[int, int]
    name: str = ""
    group: str = ""

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row(self, i: int) -> np.ndarray:
        return self.indices[self.indptr[i] : self.indptr[i + 1]]

    def row_values(self, i: int) -> np.ndarray:
        assert self.data is not None
        return self.data[self.indptr[i] : self.indptr[i + 1]]

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def copy(self) -> "CSRMatrix":
        return CSRMatrix(
            self.indptr.copy(),
            self.indices.copy(),
            None if self.data is None else self.data.copy(),
            self.shape,
            self.name,
            self.group,
        )

    def to_dense(self) -> np.ndarray:
        n, m = self.shape
        out = np.zeros((n, m), dtype=np.float64)
        rows = np.repeat(np.arange(n), self.row_lengths())
        out[rows, self.indices] = 1.0 if self.data is None else self.data
        return out

    def to_coo(self) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        rows = np.repeat(np.arange(self.n, dtype=np.int32), self.row_lengths())
        return rows, self.indices.copy(), None if self.data is None else self.data.copy()

    def transpose(self) -> "CSRMatrix":
        rows, cols, data = self.to_coo()
        return coo_to_csr(cols, rows, data, self.shape[::-1], self.name, self.group)

    def is_structurally_symmetric(self) -> bool:
        t = self.transpose()
        return (
            np.array_equal(self.indptr, t.indptr)
            and np.array_equal(self.indices, t.indices)
        )

    def has_full_diagonal(self) -> bool:
        for i in range(self.n):
            if i not in self.row(i):
                return False
        return True

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """A @ x for a single RHS ``(n,)`` or an RHS block ``(n, k)``."""
        assert self.data is not None
        rows = np.repeat(np.arange(self.n), self.row_lengths())
        if x.ndim == 1:
            out = np.zeros(self.n, dtype=np.result_type(self.data, x))
            np.add.at(out, rows, self.data * x[self.indices])
        else:
            out = np.zeros((self.n, x.shape[1]),
                           dtype=np.result_type(self.data, x))
            np.add.at(out, rows, self.data[:, None] * x[self.indices])
        return out


def coo_to_csr(
    rows: np.ndarray,
    cols: np.ndarray,
    data: Optional[np.ndarray],
    shape: Tuple[int, int],
    name: str = "",
    group: str = "",
    sum_duplicates: bool = True,
) -> CSRMatrix:
    """Build CSR from COO triplets; sorts columns within rows, merges dups."""
    n = shape[0]
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    vals = None if data is None else np.asarray(data, dtype=np.float64)[order]
    if rows.size and sum_duplicates:
        keep = np.ones(rows.size, dtype=bool)
        keep[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        if not keep.all():
            if vals is not None:
                seg = np.cumsum(keep) - 1
                summed = np.zeros(int(seg[-1]) + 1, dtype=np.float64)
                np.add.at(summed, seg, vals)
                vals = summed
            rows, cols = rows[keep], cols[keep]
    indptr = np.zeros(n + 1, dtype=np.int32)
    np.add.at(indptr, rows.astype(np.int64) + 1, 1)
    indptr = np.cumsum(indptr, dtype=np.int64).astype(np.int32)
    return CSRMatrix(indptr, cols.astype(np.int32), vals, shape, name, group)


def csr_from_dense(a: np.ndarray, name: str = "", group: str = "") -> CSRMatrix:
    rows, cols = np.nonzero(a)
    return coo_to_csr(rows, cols, a[rows, cols], a.shape, name, group)


def bandwidth(a: CSRMatrix) -> int:
    """Bandwidth = max_{a_ij != 0} |i - j|   (paper Eq. 2)."""
    if a.nnz == 0:
        return 0
    rows = np.repeat(np.arange(a.n, dtype=np.int64), a.row_lengths())
    return int(np.abs(rows - a.indices.astype(np.int64)).max())


def profile(a: CSRMatrix) -> int:
    """Profile = sum_i (i - min{j : a_ij != 0})   (paper Eq. 3).

    Rows with no entry left of (or on) the diagonal contribute 0. Columns
    are sorted within a row, so a row's first entry holds its minimum; the
    reference's row loop is vectorized here (same integer result).
    """
    lo, hi = a.indptr[:-1], a.indptr[1:]
    rows = np.nonzero(hi > lo)[0]
    jmin = a.indices[lo[rows]].astype(np.int64)
    return int(np.maximum(rows - jmin, 0).sum())


# Permutation  B = P A Pᵀ  with  B[k, l] = A[perm[k], perm[l]]: `perm` lists
# old indices in new order (perm[new] = old), the convention of every
# reordering routine in repro_torch.sparse.reorder.

def permute_symmetric(a: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    n = a.n
    perm = np.asarray(perm, dtype=np.int64)
    assert perm.shape == (n,)
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    rows, cols, data = a.to_coo()
    return coo_to_csr(inv[rows], inv[cols], data, a.shape, a.name, a.group,
                      sum_duplicates=False)


def symmetrize_pattern(a: CSRMatrix) -> CSRMatrix:
    """Pattern of A + Aᵀ (values summed where both exist)."""
    r1, c1, d1 = a.to_coo()
    rows = np.concatenate([r1, c1])
    cols = np.concatenate([c1, r1])
    data = None if d1 is None else np.concatenate([d1, d1]) * 0.5
    return coo_to_csr(rows, cols, data, a.shape, a.name, a.group)


def make_spd(a: CSRMatrix, shift: float = 1.0) -> CSRMatrix:
    """Return a symmetric positive-definite matrix with A's symmetrized
    pattern: |A|+|Aᵀ| off-diagonal, diagonally-dominant diagonal."""
    s = symmetrize_pattern(a)
    rows, cols, data = s.to_coo()
    data = np.abs(data) if data is not None else np.ones(rows.shape[0])
    off = rows != cols
    rows, cols, data = rows[off], cols[off], -data[off]
    rowsum = np.zeros(s.n)
    np.add.at(rowsum, rows, -data)
    diag = rowsum + shift
    rows = np.concatenate([rows, np.arange(s.n)])
    cols = np.concatenate([cols, np.arange(s.n)])
    data = np.concatenate([data, diag])
    return coo_to_csr(rows, cols, data, a.shape, a.name, a.group)
