"""Copy of ``repro/sparse/reorder/nd.py`` (``nd_order``,
``nd_order_with_leaf``).

Nested dissection [George 1973] via recursive vertex-separator bisection.

The partitioner is METIS-flavoured but self-contained:

1. pick a pseudo-peripheral root, build the BFS level structure;
2. split at the level that balances the two halves (edge separator);
3. convert to a vertex separator by taking the smaller boundary side;
4. a boundary-refinement pass shrinks the separator greedily
   (Fiduccia–Mattheyses-style single moves, gain = separator-size delta);
5. recurse on the two parts; separator vertices are numbered LAST.

Leaves smaller than ``leaf_size`` are ordered by the supplied leaf ordering
(natural for pure ND; AMD for the SCOTCH-like hybrid in ``hybrid.py``).

Returns ``perm`` with ``perm[new] = old``.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from ..csr import CSRMatrix, coo_to_csr
from ..graph import adjacency, connected_components, pseudo_peripheral_node

__all__ = ["nd_order", "nd_order_with_leaf"]


def _subgraph(adj: CSRMatrix, verts: np.ndarray):
    """Induced subgraph; returns (sub_adj, local→global map)."""
    gmap = verts
    lmap = -np.ones(adj.n, dtype=np.int64)
    lmap[verts] = np.arange(verts.size)
    rows_out, cols_out = [], []
    indptr, indices = adj.indptr, adj.indices
    for li, v in enumerate(verts):
        nbr = indices[indptr[v] : indptr[v + 1]]
        keep = lmap[nbr] >= 0
        if keep.any():
            nb = lmap[nbr[keep]]
            rows_out.append(np.full(nb.size, li, dtype=np.int64))
            cols_out.append(nb)
    if rows_out:
        rows = np.concatenate(rows_out)
        cols = np.concatenate(cols_out)
    else:
        rows = cols = np.empty(0, dtype=np.int64)
    sub = coo_to_csr(rows, cols, None, (verts.size, verts.size),
                     sum_duplicates=False)
    return sub, gmap


def _vertex_separator(adj: CSRMatrix) -> Optional[tuple]:
    """Bisect one connected graph; returns (part0, part1, sep) local ids."""
    n = adj.n
    if n < 2:
        return None
    root, levels = pseudo_peripheral_node(adj, 0)
    if len(levels) < 3:
        # Graph is (almost) a clique / too shallow to dissect.
        return None
    sizes = np.array([lv.size for lv in levels])
    cum = np.cumsum(sizes)
    # Choose split level t: vertices in levels < t go to part0.
    t = int(np.searchsorted(cum, n / 2.0)) + 1
    t = max(1, min(t, len(levels) - 1))
    level_of = np.full(n, -1, dtype=np.int64)
    for d, lv in enumerate(levels):
        level_of[lv] = d
    part0_mask = (level_of >= 0) & (level_of < t)
    part1_mask = level_of >= t

    indptr, indices = adj.indptr, adj.indices
    # Boundary candidates on each side of the cut.
    cand0 = []
    for v in np.nonzero(part0_mask)[0]:
        nbr = indices[indptr[v] : indptr[v + 1]]
        if part1_mask[nbr].any():
            cand0.append(v)
    cand1 = []
    for v in np.nonzero(part1_mask)[0]:
        nbr = indices[indptr[v] : indptr[v + 1]]
        if part0_mask[nbr].any():
            cand1.append(v)
    sep = np.array(cand0 if len(cand0) <= len(cand1) else cand1, dtype=np.int64)

    in_sep = np.zeros(n, dtype=bool)
    in_sep[sep] = True

    # Greedy refinement: drop separator vertices whose neighbourhood touches
    # only one side (they can join that side), repeat until fixpoint.
    changed = True
    while changed:
        changed = False
        for v in np.nonzero(in_sep)[0]:
            nbr = indices[indptr[v] : indptr[v + 1]]
            nbr = nbr[~in_sep[nbr]]
            touches0 = part0_mask[nbr].any()
            touches1 = part1_mask[nbr].any()
            if not (touches0 and touches1):
                in_sep[v] = False
                if touches1:
                    part0_mask[v], part1_mask[v] = False, True
                else:
                    part1_mask[v], part0_mask[v] = False, True
                changed = True
    part0_mask &= ~in_sep
    part1_mask &= ~in_sep
    p0 = np.nonzero(part0_mask)[0]
    p1 = np.nonzero(part1_mask)[0]
    s = np.nonzero(in_sep)[0]
    if p0.size == 0 or p1.size == 0:
        return None
    return p0, p1, s


def nd_order_with_leaf(a: CSRMatrix, leaf_order: Callable[[CSRMatrix], np.ndarray],
                       leaf_size: int = 64, max_depth: int = 64) -> np.ndarray:
    adj = adjacency(a)
    out: List[int] = []

    def recurse(sub: CSRMatrix, gmap: np.ndarray, depth: int) -> np.ndarray:
        if sub.n <= leaf_size or depth >= max_depth:
            return gmap[leaf_order(sub)]

        def descend(local_verts: np.ndarray, d: int) -> np.ndarray:
            child, lmap = _subgraph(sub, local_verts)
            return recurse(child, gmap[lmap], d)  # compose local→global

        comps = connected_components(sub)
        if len(comps) > 1:
            return np.concatenate([descend(c, depth) for c in comps])
        cut = _vertex_separator(sub)
        if cut is None:
            return gmap[leaf_order(sub)]
        p0, p1, s = cut
        pieces = [descend(p0, depth + 1), descend(p1, depth + 1)]
        if s.size:
            pieces.append(gmap[s])  # separator numbered last
        return np.concatenate(pieces)

    perm = recurse(adj, np.arange(adj.n, dtype=np.int64), 0)
    assert perm.size == adj.n
    return perm


def nd_order(a: CSRMatrix, leaf_size: int = 64) -> np.ndarray:
    """Pure nested dissection: natural order inside the leaves."""
    return nd_order_with_leaf(a, lambda s: np.arange(s.n, dtype=np.int64),
                              leaf_size=leaf_size)
