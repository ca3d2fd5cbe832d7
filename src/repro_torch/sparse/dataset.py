"""Copy of the grid generators of ``repro/sparse/dataset.py``
(``_sym``, ``grid2d``, ``grid3d``): 2-D 5-point and 3-D 7-point Laplacian
patterns, made SPD by :func:`repro_torch.sparse.csr.make_spd`."""
from __future__ import annotations

import numpy as np

from .csr import CSRMatrix, coo_to_csr, make_spd

__all__ = ["grid2d", "grid3d"]


def _sym(rows, cols, n, name, group) -> CSRMatrix:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    a = coo_to_csr(np.concatenate([rows, cols]), np.concatenate([cols, rows]),
                   None, (n, n), name, group)
    return make_spd(a)


def grid2d(p: int, q: int, name: str) -> CSRMatrix:
    idx = np.arange(p * q).reshape(p, q)
    r = [idx[:-1, :].ravel(), idx[:, :-1].ravel()]
    c = [idx[1:, :].ravel(), idx[:, 1:].ravel()]
    return _sym(np.concatenate(r), np.concatenate(c), p * q, name, "grid2d")


def grid3d(p: int, q: int, r_: int, name: str) -> CSRMatrix:
    idx = np.arange(p * q * r_).reshape(p, q, r_)
    r = [idx[:-1].ravel(), idx[:, :-1].ravel(), idx[:, :, :-1].ravel()]
    c = [idx[1:].ravel(), idx[:, 1:].ravel(), idx[:, :, 1:].ravel()]
    return _sym(np.concatenate(r), np.concatenate(c), p * q * r_, name, "grid3d")
