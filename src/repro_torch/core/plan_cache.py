"""Port of ``repro/core/plan_cache.py`` (:57-422): ``matrix_fingerprint``,
:class:`PlanCache`, the thread-safe in-memory LRU, and
:class:`TwoTierPlanCache`, the same LRU over a persistent disk tier.

Reordering selection is a pure function of the sparsity *structure*, so
repeat structures skip featurization, inference, reordering and symbolic
analysis. Keys are a structure fingerprint — ``(n, nnz, blake2b(indptr ‖
indices))``, the reference's bytes, so both packages key a matrix alike —
and values are :class:`repro_torch.core.plan.ExecutionPlan`\\ s (any
picklable object works).

The disk tier keeps one pickle per key, and three things keep it apart
from the reference's, whose cache versions are equal to the port's by
design:

* its default directory is :data:`DEFAULT_CACHE_DIR`
  (``artifacts/plan_cache_torch/``), not the reference's;
* its files end in :data:`PLAN_SUFFIX` (``{key}.{version}.torchplan.pkl``),
  so a reference file under the same key and version is not even seen;
* it reads through :func:`restricted_load`, whose unpickler admits only
  the exact globals in :data:`ADMITTED`: builtin data types, the numpy
  array, dtype and scalar constructors, and the port's ``ExecutionPlan``
  and ``SymbolicFactor``. A file naming any other global (a reference plan
  names ``repro.core.plan``) is an ``UnpicklingError`` before that global's
  module is imported and counts as a miss, as an unreadable file does in
  the reference, and nothing of ``repro`` or JAX is imported.
"""
from __future__ import annotations

import hashlib
import io
import os
import pickle
import tempfile
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..sparse.csr import CSRMatrix
from .locking import FileLock

__all__ = ["matrix_fingerprint", "PlanCache", "TwoTierPlanCache",
           "DEFAULT_CACHE_DIR", "PLAN_SUFFIX", "ADMITTED",
           "RestrictedUnpickler",
           "restricted_load", "restricted_loads"]

DEFAULT_CACHE_DIR = os.path.join("artifacts", "plan_cache_torch")
#: file-name ending of the port's plan files (the reference's: ``.plan.pkl``)
PLAN_SUFFIX = ".torchplan.pkl"

#: the (module, name) globals a plan file or an RPC frame may name, and no
#: others. Listed by pickling every kind of each (a pickled
#: ``ExecutionPlan``; the ``ping``, ``plan``, ``plan_batch``, ``select``,
#: ``stats``, ``metrics`` and ``shutdown`` requests and their responses,
#: and the error frames) at ``pickle.HIGHEST_PROTOCOL`` and recording what
#: the unpickler looks up: builtin data types; numpy arrays
#: (``_frombuffer``) with their ``dtype`` and numpy scalars (``scalar``),
#: under numpy 2's module names and numpy 1's; the plan's two classes.
#: The request and error frames, stats and metrics are plain dicts of
#: builtin values and arrays.
ADMITTED = frozenset(
    {("builtins", n) for n in (
        "bool", "int", "float", "complex", "str", "bytes", "bytearray",
        "tuple", "list", "dict", "set", "frozenset", "slice", "range")}
    | {("numpy", "dtype"),
       ("numpy._core.numeric", "_frombuffer"),
       ("numpy.core.numeric", "_frombuffer"),
       ("numpy._core.multiarray", "scalar"),
       ("numpy.core.multiarray", "scalar"),
       ("repro_torch.core.plan", "ExecutionPlan"),
       ("repro_torch.sparse.symbolic", "SymbolicFactor")})


class RestrictedUnpickler(pickle.Unpickler):
    """Unpickler that resolves only the exact globals of :data:`ADMITTED`;
    any other global raises :class:`pickle.UnpicklingError` before its
    module is imported."""

    def find_class(self, module: str, name: str):
        if (module, name) in ADMITTED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"global {module}.{name} is not admitted (only the plan's "
            f"classes, numpy arrays, dtypes and scalars, and builtin data "
            f"types)")


def restricted_load(f) -> Any:
    return RestrictedUnpickler(f).load()


def restricted_loads(data: bytes) -> Any:
    return RestrictedUnpickler(io.BytesIO(data)).load()


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

    Thread-safe: memory-tier state is only touched under ``self._lock``
    (reentrant), so one instance is shared by the dispatcher's batcher and
    build workers; second-tier (disk) I/O runs *outside* the lock so it
    never stalls concurrent warm-path gets. With a ``metrics`` registry
    (:class:`repro_torch.core.metrics.MetricsRegistry`) every count also
    lands in ``<metrics_prefix>.*``; the attribute counters stay the source
    of ``stats()``.
    """

    def __init__(self, capacity: int = 4096, *, metrics=None,
                 metrics_prefix: str = "cache"):
        assert capacity >= 1
        self.capacity = capacity
        self._store: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._metrics = metrics
        self._metrics_prefix = metrics_prefix

    def _minc(self, name: str, n: int = 1) -> None:
        if self._metrics is not None:
            self._metrics.counter(f"{self._metrics_prefix}.{name}").inc(n)

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
                self._minc("memory_hits")
                return self._store[key]
        # second-tier lookup runs WITHOUT the lock: disk reads must not
        # stall concurrent warm-path gets (no-op for the memory-only cache)
        plan = self._tier_load(key)
        with self._lock:
            if plan is not None:
                self.hits += 1
                self._tier_hit_locked()
                self._install_locked(key, plan)
                return plan
            self.misses += 1
        self._minc("misses")
        return None

    def peek(self, key: str) -> Optional[Any]:
        """Memory-tier lookup without touching LRU order or counters (the
        dispatcher's double-check after a sibling's build, which must not
        skew stats)."""
        with self._lock:
            return self._store.get(key)

    def put(self, key: str, plan: Any) -> None:
        with self._lock:
            self._install_locked(key, plan)
        # disk write outside the lock: the tempfile + rename is atomic, so
        # concurrent writers of one key are last-rename-wins safe, and a
        # failed write leaves the plan served from memory
        self._tier_store(key, plan)

    def _install_locked(self, key: str, plan: Any) -> None:
        """Insert into the memory LRU (caller holds the lock)."""
        if key in self._store:
            self._store.move_to_end(key)
        self._store[key] = plan
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)
            self.evictions += 1
            self._minc("evictions")

    # second-tier hooks — no-ops for the memory-only cache ------------------
    def _tier_load(self, key: str) -> Optional[Any]:
        """Fetch from the second tier; called WITHOUT the lock held."""
        return None

    def _tier_hit_locked(self) -> None:
        """Account a second-tier hit; called with the lock held."""

    def _tier_store(self, key: str, plan: Any) -> None:
        """Write to the second tier; called WITHOUT the lock held."""

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


class TwoTierPlanCache(PlanCache):
    """Memory LRU over a persistent pickle-per-key disk tier.

    ``get`` falls through memory → disk → miss; a disk hit promotes the
    plan back into the LRU (counted in ``hits`` and ``disk_hits``). ``put``
    writes both tiers, the disk write atomically (tempfile + rename). Disk
    entries outlive LRU eviction and the process.

    ``version`` namespaces the files (the engine derives it from the served
    model's fingerprint, so a new model makes every old entry a miss).
    ``max_disk_bytes`` / ``max_disk_entries`` bound the tier: once either
    is exceeded after a write, the port's plan files of *every* version are
    evicted LRU-by-mtime (a disk hit refreshes the mtime). The tier is
    replica-shared: reads and writes need no coordination; the eviction
    sweep is single-flight across processes through ``.sweep.lock`` (always
    tried non-blocking: a loser skips) and usage scans are consistent
    through ``.scan.lock`` (shared for scans, exclusive with a bounded wait
    for the sweep's delete pass), both :class:`FileLock`\\ s.
    """

    def __init__(self, capacity: int = 4096,
                 cache_dir: str = DEFAULT_CACHE_DIR, version: str = "v0",
                 max_disk_bytes: Optional[int] = None,
                 max_disk_entries: Optional[int] = None, *,
                 metrics=None, metrics_prefix: str = "cache"):
        super().__init__(capacity, metrics=metrics,
                         metrics_prefix=metrics_prefix)
        self.cache_dir = cache_dir
        self.version = version
        self.max_disk_bytes = max_disk_bytes
        self.max_disk_entries = max_disk_entries
        os.makedirs(cache_dir, exist_ok=True)
        self.disk_hits = 0
        self.disk_writes = 0
        self.disk_errors = 0
        self.disk_evictions = 0
        # one sweeper at a time in this process; a writer that finds a sweep
        # running skips instead of queueing
        self._evict_lock = threading.Lock()
        # two sidecar flocks, because one lock cannot both let a sweep skip
        # past a *sweeping* sibling and wait behind a *scanning* one (with
        # one lock, a trickle of stats polls would starve eviction)
        self._sweep_lock = FileLock(os.path.join(cache_dir, ".sweep.lock"))
        self._scan_lock = FileLock(os.path.join(cache_dir, ".scan.lock"))

    def _suffix(self) -> str:
        return f".{self.version}{PLAN_SUFFIX}"

    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir, key + self._suffix())

    def _tier_load(self, key: str) -> Optional[Any]:
        path = self._path(key)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                plan = restricted_load(f)
        except (OSError, pickle.UnpicklingError, EOFError):
            return None  # unreadable or foreign entry ≡ miss; put overwrites
        try:
            # a disk hit refreshes mtime so the sweep's order is recency of
            # use, not of write
            os.utime(path, None)
        except OSError:
            pass
        return plan

    def _tier_hit_locked(self) -> None:
        self.disk_hits += 1
        self._minc("disk_hits")

    def _tier_store(self, key: str, plan: Any) -> None:
        try:
            fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    pickle.dump(plan, f, protocol=pickle.HIGHEST_PROTOCOL)
                os.replace(tmp, self._path(key))
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise
        except (OSError, pickle.PicklingError, AttributeError, TypeError):
            # disk full / unwritable dir / unpicklable plan (a local object
            # raises AttributeError, a lock TypeError, where the reference
            # catches only PicklingError): the memory tier holds the plan
            with self._lock:
                self.disk_errors += 1
            self._minc("disk_errors")
            return
        with self._lock:
            self.disk_writes += 1
        self._minc("disk_writes")
        self._evict_disk()

    def _evict_disk(self) -> None:
        """Enforce the disk budgets (see the class docstring). Runs outside
        the memory-tier lock; ``_evict_lock`` and ``.sweep.lock`` are both
        taken non-blocking, so the budget is a soft bound under concurrency
        (a file written after a running sweep's listing survives until the
        next write) and no writer ever waits on another's sweep. The scan
        lock is waited for at most 0.25 s: this runs on a build worker's
        put path, and flock gives an exclusive waiter no priority over a
        stream of shared holders."""
        if self.max_disk_bytes is None and self.max_disk_entries is None:
            return
        if not self._evict_lock.acquire(blocking=False):
            return
        try:
            if not self._sweep_lock.acquire(blocking=False):
                return  # a sibling replica is sweeping this tier
            try:
                if not self._scan_lock.acquire(timeout=0.25):
                    return
                try:
                    self._evict_disk_locked()
                finally:
                    self._scan_lock.release()
            finally:
                self._sweep_lock.release()
        finally:
            self._evict_lock.release()

    def _evict_disk_locked(self) -> None:
        entries = []
        for f in os.listdir(self.cache_dir):
            if not f.endswith(PLAN_SUFFIX):
                continue
            try:
                st = os.stat(os.path.join(self.cache_dir, f))
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, f))
        entries.sort()  # oldest first
        total = sum(e[1] for e in entries)
        count = len(entries)
        evicted = 0
        for _mtime, size, f in entries:
            over_bytes = (self.max_disk_bytes is not None
                          and total > self.max_disk_bytes)
            over_count = (self.max_disk_entries is not None
                          and count > self.max_disk_entries)
            if not over_bytes and not over_count:
                break
            try:
                os.unlink(os.path.join(self.cache_dir, f))
            except FileNotFoundError:
                pass  # already gone: off the budget, but not our eviction
            except OSError:
                continue  # undeletable: keep it charged against the budget
            else:
                evicted += 1
            total -= size
            count -= 1
        if evicted:
            with self._lock:
                self.disk_evictions += evicted
            self._minc("disk_evictions", evicted)

    def _disk_usage(self) -> "Tuple[int, int]":
        """One scandir pass under the shared scan lock → (entries of *this*
        version, bytes of the port's plan files of *all* versions: what the
        byte budget is charged against)."""
        entries = 0
        total = 0
        suffix = self._suffix()
        with self._scan_lock.shared(), os.scandir(self.cache_dir) as it:
            for e in it:
                if not e.name.endswith(PLAN_SUFFIX):
                    continue
                if e.name.endswith(suffix):
                    entries += 1
                try:
                    total += e.stat().st_size
                except OSError:
                    pass
        return entries, total

    def disk_entries(self) -> int:
        return self._disk_usage()[0]

    def disk_bytes(self) -> int:
        return self._disk_usage()[1]

    def clear_disk(self) -> None:
        """Delete this version's plan files."""
        with self._scan_lock.exclusive():
            for f in os.listdir(self.cache_dir):
                if f.endswith(self._suffix()):
                    try:
                        os.unlink(os.path.join(self.cache_dir, f))
                    except FileNotFoundError:
                        pass  # a sibling replica got there first

    def reset_stats(self) -> None:
        with self._lock:
            super().reset_stats()
            self.disk_hits = self.disk_writes = self.disk_errors = 0
            self.disk_evictions = 0

    def stats(self) -> Dict[str, float]:
        entries, nbytes = self._disk_usage()  # one scan, outside the lock
        with self._lock:
            s = super().stats()
            s.update(disk_hits=self.disk_hits, disk_writes=self.disk_writes,
                     disk_errors=self.disk_errors,
                     disk_evictions=self.disk_evictions,
                     memory_hits=self.hits - self.disk_hits,
                     disk_entries=entries, disk_bytes=nbytes,
                     max_disk_bytes=self.max_disk_bytes,
                     max_disk_entries=self.max_disk_entries)
            return s
