"""Copy of ``repro/sparse/reorder/amd.py``.

Minimum-degree family orderings on the quotient (element) graph.

Implements the fill-reducing family the paper labels "AMD, AMF, QAMD"
(Table 2):

* ``md``   — exact external-degree minimum degree [Tinney & Walker 1967].
* ``amd``  — approximate minimum degree [Amestoy, Davis & Duff 1996]: the
  degree bound  d_i ≤ |A_i| + |L_p \\ i| + Σ_{e∈E_i, e≠p} |L_e \\ L_p|
  is maintained instead of the exact external degree.
* ``qamd`` — AMD with aggressive element absorption (elements whose boundary
  is contained in the new element are absorbed even when not adjacent to the
  pivot), MUMPS's QAMD flavour.
* ``amf``  — approximate minimum fill: pivots scored by the fill estimate
  d·(d−1)/2 − Σ_e C(|L_e ∩ adj|, 2) instead of the degree.

All use the quotient-graph representation: each uneliminated variable ``i``
keeps a set of variable neighbours ``A[i]`` and a set of element neighbours
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

__all__ = ["md_order", "amd_order", "qamd_order", "amf_order"]


def _quotient_md(a: CSRMatrix, *, approximate: bool, aggressive: bool,
                 min_fill: bool) -> np.ndarray:
    adj = adjacency(a)
    n = adj.n
    if n == 0:
        return np.empty(0, dtype=np.int64)

    A: List[Set[int]] = [set(adj.row(i).tolist()) for i in range(n)]
    E: List[Set[int]] = [set() for _ in range(n)]
    L: Dict[int, Set[int]] = {}          # element boundaries
    alive = np.ones(n, dtype=bool)
    absorbed: Set[int] = set()

    def exact_external_degree(i: int) -> int:
        reach: Set[int] = set(A[i])
        for e in E[i]:
            reach |= L[e]
        reach.discard(i)
        return len(reach)

    def fill_score(i: int) -> float:
        """Approximate new fill created by eliminating i (AMF)."""
        d = deg[i]
        score = d * (d - 1) / 2.0
        for e in E[i]:
            c = len(L[e] & A[i]) + len(L[e]) - 1
            score -= c * (c - 1) / 4.0  # heuristic discount for existing cliques
        return max(score, 0.0)

    deg = np.array([len(A[i]) for i in range(n)], dtype=np.int64)
    heap: List = []
    stamp = np.zeros(n, dtype=np.int64)  # lazy-invalidation counter
    for i in range(n):
        key = fill_score(i) if min_fill else deg[i]
        heapq.heappush(heap, (key, i, 0))

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
            absorbed.add(e)
        Lp.discard(p)
        Lp = {i for i in Lp if alive[i]}

        # Absorb p's elements everywhere they appear.
        dead = E[p]
        if aggressive:
            # Aggressive absorption: also kill elements fully covered by Lp.
            for i in list(Lp):
                for e in list(E[i]):
                    if e not in dead and L[e] <= (Lp | {p}):
                        dead = dead | {e}
                        absorbed.add(e)
        L[p] = Lp
        E[p] = set()
        A[p] = set()

        lp1 = len(Lp) - 1
        for i in Lp:
            A[i] -= Lp
            A[i].discard(p)
            E[i] -= dead
            E[i].add(p)
            if min_fill:
                deg[i] = len(A[i]) + lp1 + sum(len(L[e] - Lp) for e in E[i] if e != p)
                key = fill_score(i)
            elif approximate:
                # AMD bound: |A_i| + |Lp \ i| + Σ_{e≠p} |L_e \ Lp|.
                d = len(A[i]) + lp1
                for e in E[i]:
                    if e != p:
                        d += len(L[e]) - len(L[e] & Lp)
                deg[i] = min(d, n - k - 1)
                key = deg[i]
            else:
                deg[i] = exact_external_degree(i)
                key = deg[i]
            stamp[i] += 1
            heapq.heappush(heap, (key, i, int(stamp[i])))

        for e in dead:
            L.pop(e, None)
    return order


def md_order(a: CSRMatrix) -> np.ndarray:
    return _quotient_md(a, approximate=False, aggressive=False, min_fill=False)


def amd_order(a: CSRMatrix) -> np.ndarray:
    return _quotient_md(a, approximate=True, aggressive=False, min_fill=False)


def qamd_order(a: CSRMatrix) -> np.ndarray:
    return _quotient_md(a, approximate=True, aggressive=True, min_fill=False)


def amf_order(a: CSRMatrix) -> np.ndarray:
    return _quotient_md(a, approximate=True, aggressive=False, min_fill=True)
