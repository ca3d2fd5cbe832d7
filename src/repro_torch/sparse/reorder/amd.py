"""Copy of ``repro/sparse/reorder/amd.py``: ``amd_order`` (the
``approximate=True`` branch of ``_quotient_md``; the ``md``, ``qamd`` and
``amf`` variants are not among the paper's four labels and were left out).

Approximate minimum degree [Amestoy, Davis & Duff 1996] on the quotient
(element) graph: the degree bound
d_i ≤ |A_i| + |L_p \\ i| + Σ_{e∈E_i, e≠p} |L_e \\ L_p| is maintained
instead of the exact external degree. Each uneliminated variable ``i`` keeps
a set of variable neighbours ``A[i]`` and a set of element neighbours
``E[i]``; each eliminated pivot becomes an element ``p`` with boundary
``L[p]``. Elimination never forms explicit cliques, so memory stays O(nnz).

Returns ``perm`` with ``perm[new] = old``.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Set

import numpy as np

from ..csr import CSRMatrix
from ..graph import adjacency

__all__ = ["amd_order"]


def amd_order(a: CSRMatrix) -> np.ndarray:
    adj = adjacency(a)
    n = adj.n
    if n == 0:
        return np.empty(0, dtype=np.int64)

    A: List[Set[int]] = [set(adj.row(i).tolist()) for i in range(n)]
    E: List[Set[int]] = [set() for _ in range(n)]
    L: Dict[int, Set[int]] = {}          # element boundaries
    alive = np.ones(n, dtype=bool)

    deg = np.array([len(A[i]) for i in range(n)], dtype=np.int64)
    heap: List = []
    stamp = np.zeros(n, dtype=np.int64)  # lazy-invalidation counter
    for i in range(n):
        heapq.heappush(heap, (deg[i], i, 0))

    order = np.empty(n, dtype=np.int64)
    for k in range(n):
        # Pop the minimum-key live entry.
        while True:
            key, p, s = heapq.heappop(heap)
            if alive[p] and s == stamp[p]:
                break
        alive[p] = False
        order[k] = p

        # Boundary of the new element p.
        Lp: Set[int] = set(A[p])
        for e in E[p]:
            Lp |= L[e]
        Lp.discard(p)
        Lp = {i for i in Lp if alive[i]}

        # Absorb p's elements everywhere they appear.
        dead = E[p]
        L[p] = Lp
        E[p] = set()
        A[p] = set()

        lp1 = len(Lp) - 1
        for i in Lp:
            A[i] -= Lp
            A[i].discard(p)
            E[i] -= dead
            E[i].add(p)
            # AMD bound: |A_i| + |Lp \ i| + Σ_{e≠p} |L_e \ Lp|.
            d = len(A[i]) + lp1
            for e in E[i]:
                if e != p:
                    d += len(L[e]) - len(L[e] & Lp)
            deg[i] = min(d, n - k - 1)
            stamp[i] += 1
            heapq.heappush(heap, (deg[i], i, int(stamp[i])))

        for e in dead:
            L.pop(e, None)
    return order
