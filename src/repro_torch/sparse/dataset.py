"""Copy of ``repro/sparse/dataset.py``: the synthetic "Florida-like" suite.

The generators (``grid2d``, ``grid3d``, ``banded``, ``permuted_banded``,
``erdos``, ``smallworld``, ``scalefree``, ``block_arrow``,
``triangulation``, ``circuit_like``, ``path_ring``), ``GENERATORS``,
``generate_suite`` (:176) and ``suite_summary``. Every generator returns an
SPD :class:`CSRMatrix` via :func:`make_spd`, and the same seed gives the
same matrices as the reference: 2D/3D grid Laplacians, long thin grids and
paths/rings, banded and randomly permuted banded matrices, Erdős–Rényi and
small-world graphs, scale-free graphs, block-arrow matrices, random planar
triangulations and circuit-like patterns.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Iterator, List

import numpy as np

from .csr import CSRMatrix, coo_to_csr, make_spd, permute_symmetric

__all__ = ["generate_suite", "GENERATORS", "suite_summary", "grid2d",
           "grid3d", "banded", "permuted_banded", "erdos", "smallworld",
           "scalefree", "block_arrow", "triangulation", "circuit_like",
           "path_ring"]


def _sym(rows, cols, n, name, group) -> CSRMatrix:
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    a = coo_to_csr(np.concatenate([rows, cols]), np.concatenate([cols, rows]),
                   None, (n, n), name, group)
    return make_spd(a)


# --- generators -------------------------------------------------------------

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


def banded(n: int, band: int, density: float, rng, name: str) -> CSRMatrix:
    rows, cols = [], []
    for d in range(1, band + 1):
        m = n - d
        keep = rng.random(m) < density
        i = np.nonzero(keep)[0]
        rows.append(i)
        cols.append(i + d)
    return _sym(np.concatenate(rows), np.concatenate(cols), n, name, "banded")


def permuted_banded(n: int, band: int, density: float, rng, name: str) -> CSRMatrix:
    a = banded(n, band, density, rng, name)
    perm = rng.permutation(n)
    b = permute_symmetric(a, perm)
    b.name, b.group = name, "permuted-banded"
    return b


def erdos(n: int, avg_deg: float, rng, name: str) -> CSRMatrix:
    m = int(n * avg_deg / 2)
    rows = rng.integers(0, n, m)
    cols = rng.integers(0, n, m)
    keep = rows != cols
    return _sym(rows[keep], cols[keep], n, name, "random")


def smallworld(n: int, k: int, extra: float, rng, name: str) -> CSRMatrix:
    i = np.arange(n)
    rows = [np.concatenate([i] * k)]
    cols = [np.concatenate([(i + d) % n for d in range(1, k + 1)])]
    m = int(n * extra)
    rows.append(rng.integers(0, n, m))
    cols.append(rng.integers(0, n, m))
    r, c = np.concatenate(rows), np.concatenate(cols)
    keep = r != c
    return _sym(r[keep], c[keep], n, name, "smallworld")


def scalefree(n: int, m_attach: int, rng, name: str) -> CSRMatrix:
    """Barabási–Albert preferential attachment."""
    targets = list(range(m_attach))
    repeated: List[int] = list(range(m_attach))
    rows, cols = [], []
    for v in range(m_attach, n):
        for t in set(targets):
            rows.append(v)
            cols.append(t)
            repeated.extend([v, t])
        targets = [repeated[rng.integers(0, len(repeated))] for _ in range(m_attach)]
    return _sym(np.array(rows), np.array(cols), n, name, "scalefree")


def block_arrow(nblocks: int, bs: int, border: int, rng, name: str) -> CSRMatrix:
    n = nblocks * bs + border
    rows, cols = [], []
    for b in range(nblocks):
        base = b * bs
        i = np.arange(bs - 1) + base
        rows.append(i)
        cols.append(i + 1)
        # couple each block to the border
        bi = rng.integers(0, bs, max(1, bs // 2)) + base
        bj = rng.integers(nblocks * bs, n, max(1, bs // 2))
        rows.append(bi)
        cols.append(bj)
    i = np.arange(border - 1) + nblocks * bs
    rows.append(i)
    cols.append(i + 1)
    return _sym(np.concatenate(rows), np.concatenate(cols), n, name, "block-arrow")


def triangulation(npts: int, rng, name: str) -> CSRMatrix:
    from scipy.spatial import Delaunay
    pts = rng.random((npts, 2))
    tri = Delaunay(pts)
    s = tri.simplices
    rows = np.concatenate([s[:, 0], s[:, 1], s[:, 2]])
    cols = np.concatenate([s[:, 1], s[:, 2], s[:, 0]])
    return _sym(rows, cols, npts, name, "fem-tri")


def circuit_like(n: int, nnz_per_row: int, rng, name: str) -> CSRMatrix:
    """Asymmetric random pattern with a few dense rows, symmetrized —
    mimics circuit-simulation matrices (the lhr/ASIC-style entries)."""
    m = n * nnz_per_row
    rows = rng.integers(0, n, m)
    cols = np.minimum(rng.geometric(p=min(0.5, 8.0 / n), size=m) +
                      rng.integers(0, n, m), n - 1) % n
    ndense = max(1, n // 200)
    drows = rng.integers(0, n, ndense)
    extra_r = np.repeat(drows, n // 20)
    extra_c = rng.integers(0, n, extra_r.size)
    r = np.concatenate([rows, extra_r])
    c = np.concatenate([cols, extra_c])
    keep = r != c
    return _sym(r[keep], c[keep], n, name, "circuit")


def path_ring(n: int, ring: bool, name: str) -> CSRMatrix:
    i = np.arange(n - 1)
    rows, cols = [i], [i + 1]
    if ring:
        rows.append(np.array([n - 1]))
        cols.append(np.array([0]))
    return _sym(np.concatenate(rows), np.concatenate(cols), n, name, "path-ring")


GENERATORS: Dict[str, Callable] = {
    "grid2d": grid2d, "grid3d": grid3d, "banded": banded,
    "permuted-banded": permuted_banded, "random": erdos,
    "smallworld": smallworld, "scalefree": scalefree,
    "block-arrow": block_arrow, "fem-tri": triangulation,
    "circuit": circuit_like, "path-ring": path_ring,
}


def generate_suite(count: int = 960, seed: int = 0,
                   size_scale: float = 1.0) -> Iterator[CSRMatrix]:
    """Yield `count` matrices cycling over families with varied parameters.

    ``size_scale`` shrinks (or grows) every instance.
    """
    rng = np.random.default_rng(seed)
    k = 0
    while k < count:
        fam = k % 12
        s = 1 + (k // 12) % 8  # size tier 1..8
        sc = size_scale
        if fam == 0:
            p = max(3, int((6 + 7 * s) * sc))
            a = grid2d(p, p, f"grid2d_{k}")
        elif fam == 1:
            p = max(3, int((4 + 2 * s) * sc))
            a = grid3d(p, p, max(2, p // 2), f"grid3d_{k}")
        elif fam == 2:
            n = max(32, int((150 + 350 * s) * sc))
            a = banded(n, int(rng.integers(2, 6 + 3 * s)),
                       float(rng.uniform(0.4, 0.95)), rng, f"banded_{k}")
        elif fam == 3:
            n = max(32, int((150 + 300 * s) * sc))
            a = permuted_banded(n, int(rng.integers(2, 5 + 2 * s)),
                                float(rng.uniform(0.5, 0.95)), rng, f"pbanded_{k}")
        elif fam == 4:
            n = max(32, int((120 + 280 * s) * sc))
            a = erdos(n, float(rng.uniform(2.0, 5.0)), rng, f"random_{k}")
        elif fam == 5:
            n = max(32, int((150 + 300 * s) * sc))
            a = smallworld(n, int(rng.integers(1, 4)),
                           float(rng.uniform(0.05, 0.4)), rng, f"smallworld_{k}")
        elif fam == 6:
            n = max(32, int((120 + 260 * s) * sc))
            a = scalefree(n, int(rng.integers(1, 4)), rng, f"scalefree_{k}")
        elif fam == 7:
            nb = max(2, int(3 + s))
            a = block_arrow(nb, max(8, int(25 * sc * s)),
                            max(4, int(10 * sc * s)), rng, f"arrow_{k}")
        elif fam == 8:
            n = max(32, int((150 + 350 * s) * sc))
            a = triangulation(n, rng, f"femtri_{k}")
        elif fam == 9:
            n = max(48, int((150 + 300 * s) * sc))
            a = circuit_like(n, int(rng.integers(2, 5)), rng, f"circuit_{k}")
        elif fam == 10:
            n = max(32, int((200 + 500 * s) * sc))
            a = path_ring(n, bool(k % 2), f"pathring_{k}")
        else:
            # long thin grid: RCM/banded-solver friendly
            p = max(2, int(4 * sc))
            q = max(16, int((60 + 150 * s) * sc))
            a = grid2d(p, q, f"thin_{k}")
            a.group = "thin-grid"
        yield a
        k += 1


def suite_summary(mats: List[CSRMatrix]) -> dict:
    by_group = collections.Counter(m.group for m in mats)
    return dict(count=len(mats), groups=dict(by_group),
                n_min=min(m.n for m in mats), n_max=max(m.n for m in mats),
                nnz_max=max(m.nnz for m in mats))
