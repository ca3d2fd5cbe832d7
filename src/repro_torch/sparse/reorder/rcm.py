"""Copy of ``repro/sparse/reorder/rcm.py`` (``cm_order``, ``rcm_order``).

Cuthill–McKee and Reverse Cuthill–McKee bandwidth-reducing orderings.

CM [Cuthill & McKee 1969]: BFS from a pseudo-peripheral node, visiting the
children of each vertex in order of increasing degree. RCM [Liu & Sherman
1976] reverses the CM numbering, which provably never increases (and usually
decreases) the envelope/profile.

Returns `perm` with ``perm[new] = old`` — apply with
:func:`repro.sparse.csr.permute_symmetric`.
"""
from __future__ import annotations

import numpy as np

from ..csr import CSRMatrix
from ..graph import adjacency, degrees, pseudo_peripheral_node

__all__ = ["cm_order", "rcm_order"]


def cm_order(a: CSRMatrix) -> np.ndarray:
    adj = adjacency(a)
    n = adj.n
    deg = degrees(adj)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    indptr, indices = adj.indptr, adj.indices

    # Process vertices in min-degree order so each component starts from a
    # low-degree seed (then refined to pseudo-peripheral).
    seeds = np.argsort(deg, kind="stable")
    for seed in seeds:
        if visited[seed]:
            continue
        root, _ = pseudo_peripheral_node(adj, int(seed), mask=~visited)
        # BFS with degree-sorted children.
        queue = [root]
        visited[root] = True
        head = 0
        while head < len(queue):
            v = queue[head]
            head += 1
            order[pos] = v
            pos += 1
            nbr = indices[indptr[v] : indptr[v + 1]]
            nbr = nbr[~visited[nbr]]
            if nbr.size:
                nbr = nbr[np.argsort(deg[nbr], kind="stable")]
                visited[nbr] = True
                queue.extend(int(u) for u in nbr)
    assert pos == n
    return order


def rcm_order(a: CSRMatrix) -> np.ndarray:
    return cm_order(a)[::-1].copy()
