"""Copy of ``repro/sparse/graph.py`` (``adjacency``, ``degrees``,
``bfs_levels``, ``pseudo_peripheral_node``, ``connected_components``).

Adjacency-graph utilities shared by the reordering algorithms.

A sparse matrix's *graph* is the undirected graph of its symmetrized
off-diagonal pattern. All reordering algorithms in the paper (CM/RCM, MD/AMD,
ND, SCOTCH-like hybrids) operate on this graph.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .csr import CSRMatrix, coo_to_csr, symmetrize_pattern

__all__ = [
    "adjacency",
    "degrees",
    "bfs_levels",
    "pseudo_peripheral_node",
    "connected_components",
]


def adjacency(a: CSRMatrix) -> CSRMatrix:
    """Undirected adjacency structure: symmetrized pattern, no diagonal."""
    s = a if a.is_structurally_symmetric() else symmetrize_pattern(a)
    rows, cols, _ = s.to_coo()
    off = rows != cols
    return coo_to_csr(rows[off], cols[off], None, a.shape, a.name, a.group,
                      sum_duplicates=False)


def degrees(adj: CSRMatrix) -> np.ndarray:
    return np.diff(adj.indptr).astype(np.int64)


def bfs_levels(adj: CSRMatrix, root: int,
               mask: np.ndarray | None = None) -> Tuple[np.ndarray, List[np.ndarray]]:
    """BFS level structure from `root`.

    Returns (level, levels) where level[v] = depth or -1 if unreached /
    masked out, and levels is the list of per-depth vertex arrays.
    """
    n = adj.n
    level = np.full(n, -1, dtype=np.int64)
    if mask is not None:
        allowed = mask
    else:
        allowed = np.ones(n, dtype=bool)
    if not allowed[root]:
        return level, []
    level[root] = 0
    frontier = np.array([root], dtype=np.int64)
    levels = [frontier]
    depth = 0
    indptr, indices = adj.indptr, adj.indices
    while frontier.size:
        # Gather all neighbours of the frontier, vectorized.
        starts, ends = indptr[frontier], indptr[frontier + 1]
        total = int((ends - starts).sum())
        if total == 0:
            break
        nbr = np.empty(total, dtype=np.int64)
        pos = 0
        for s, e in zip(starts, ends):
            nbr[pos : pos + (e - s)] = indices[s:e]
            pos += e - s
        nbr = np.unique(nbr)
        new = nbr[(level[nbr] == -1) & allowed[nbr]]
        if new.size == 0:
            break
        depth += 1
        level[new] = depth
        frontier = new
        levels.append(frontier)
    return level, levels


def pseudo_peripheral_node(adj: CSRMatrix, start: int,
                           mask: np.ndarray | None = None) -> Tuple[int, List[np.ndarray]]:
    """George–Liu pseudo-peripheral node finder.

    Repeatedly BFS from the minimum-degree vertex of the deepest level until
    eccentricity stops growing. Returns (root, its level structure).
    """
    deg = degrees(adj)
    root = start
    _, levels = bfs_levels(adj, root, mask)
    if not levels:
        return root, levels
    ecc = len(levels) - 1
    for _ in range(16):  # converges in a couple of rounds in practice
        last = levels[-1]
        cand = last[np.argmin(deg[last])]
        _, levels2 = bfs_levels(adj, int(cand), mask)
        ecc2 = len(levels2) - 1
        if ecc2 <= ecc:
            return root, levels
        root, levels, ecc = int(cand), levels2, ecc2
    return root, levels


def connected_components(adj: CSRMatrix) -> List[np.ndarray]:
    """Vertex sets of connected components (BFS flood fill)."""
    n = adj.n
    seen = np.zeros(n, dtype=bool)
    comps: List[np.ndarray] = []
    for v in range(n):
        if seen[v]:
            continue
        level, levels = bfs_levels(adj, v, mask=~seen)
        verts = np.concatenate(levels) if levels else np.array([v], dtype=np.int64)
        seen[verts] = True
        comps.append(np.sort(verts))
    return comps
