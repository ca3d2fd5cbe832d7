"""Port of ``repro/core/plan_cache.py``: ``matrix_fingerprint`` and
:class:`PlanCache`, the in-memory LRU tier (:57-164).

Reordering selection is a pure function of the sparsity *structure*, so
repeat structures skip featurization, inference, reordering and symbolic
analysis. Keys are a structure fingerprint — ``(n, nnz, blake2b(indptr ‖
indices))``, the reference's bytes, so both packages key a matrix alike —
and values are :class:`repro_torch.core.plan.ExecutionPlan`\\ s. The disk
tier (``TwoTierPlanCache``) and the metrics mirror are not ported yet.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional

import numpy as np

from ..sparse.csr import CSRMatrix

__all__ = ["matrix_fingerprint", "PlanCache"]


def matrix_fingerprint(a: CSRMatrix) -> str:
    """Structure fingerprint: n, nnz, and a hash of the CSR index buffers.

    Values (``a.data``) are deliberately excluded — ordering depends only on
    the pattern, so numerically-different instances of one structure share a
    cache entry.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(a.n).tobytes())
    h.update(np.int64(a.nnz).tobytes())
    h.update(np.ascontiguousarray(a.indptr, dtype=np.int32).tobytes())
    h.update(np.ascontiguousarray(a.indices, dtype=np.int32).tobytes())
    return h.hexdigest()


class PlanCache:
    """Bounded LRU mapping fingerprint → plan, with hit/miss accounting.

    Thread-safe: state is only touched under ``self._lock``.
    """

    def __init__(self, capacity: int = 4096):
        assert capacity >= 1
        self.capacity = capacity
        self._store: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._store

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            if key in self._store:
                self._store.move_to_end(key)
                self.hits += 1
                return self._store[key]
            self.misses += 1
            return None

    def put(self, key: str, plan: Any) -> None:
        with self._lock:
            if key in self._store:
                self._store.move_to_end(key)
            self._store[key] = plan
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)
                self.evictions += 1

    def reset_stats(self) -> None:
        """Zero the accounting counters (entries stay cached)."""
        with self._lock:
            self.hits = self.misses = self.evictions = 0

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return dict(size=len(self._store), capacity=self.capacity,
                        hits=self.hits, misses=self.misses,
                        evictions=self.evictions,
                        hit_rate=self.hits / total if total else 0.0)
