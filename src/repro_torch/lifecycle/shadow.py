"""Port of ``repro/lifecycle/shadow.py``: shadow serving, a candidate
selector riding next to the incumbent.

A :class:`ShadowEvaluator` receives a *mirror* of the serving path's
selection decisions — ``observe(mat, incumbent_algorithm)`` is called by
the dispatcher at the same points it resolves real traffic — and scores a
candidate bundle against them **entirely off the hot path**:

* ``observe`` is O(enqueue): it never runs inference, never raises, and
  never blocks (a full mirror queue drops the observation and counts it —
  shadow fidelity degrades before client latency does).
* A daemon worker drains the queue, runs the candidate's selection on the
  host path (``ReorderSelector.select``: the host featurizer and the
  model's host forward, so the worker never touches the card, its kernels
  or the forest's device cache), and scores the disagreements by
  **counterfactual predicted flops**: reorder
  + symbolic analysis under each choice, win = the candidate's ordering
  would have cost no more factorization flops than the incumbent's.
  Agreements count as wins (matching production is never a regression).
  Symbolic analyses are memoized per (structure, algorithm), so hot
  structures are scored once.
* Everything lands in ``shadow.*`` metrics (requests / evaluated /
  agreements / disagreements / wins / losses / dropped / errors counters,
  agreement-rate and win-rate gauges, per-evaluation latency histogram)
  and in ``stats()`` — the evidence :func:`repro_torch.lifecycle.promote
  .evaluate_gate` consumes.

The client-visible response is untouched by construction: the dispatcher
only ever hands the evaluator a reference after the real plan is already
resolved (or its build already queued).
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Dict, Optional, Tuple

from ..core.plan_cache import matrix_fingerprint
from ..engine.bundle import SelectorBundle

__all__ = ["ShadowEvaluator"]

_SENTINEL = object()


class ShadowEvaluator:
    """Score a candidate selector against mirrored incumbent decisions.

    ``candidate`` may be a :class:`SelectorBundle`, a path to one, or a
    fitted ``ReorderSelector`` (in which case no bundle rides along and
    ``SolverEngine.promote()`` must be given the bundle explicitly).
    """

    def __init__(self, candidate, *, metrics=None, max_queue: int = 512,
                 flops_cache: int = 4096):
        from ..core.selector import ReorderSelector

        self.bundle: Optional[SelectorBundle] = None
        if isinstance(candidate, str):
            candidate = SelectorBundle.load(candidate)
        if isinstance(candidate, SelectorBundle):
            self.bundle = candidate
            self.selector = candidate.to_selector()
        elif isinstance(candidate, ReorderSelector):
            self.selector = candidate
        else:
            raise TypeError(
                f"candidate must be a SelectorBundle, a bundle path, or a "
                f"ReorderSelector, got {type(candidate).__name__}")
        self.candidate_fingerprint = (
            self.bundle.fingerprint if self.bundle is not None
            else SelectorBundle.from_selector(self.selector).fingerprint)

        if metrics is None:
            from ..core.metrics import MetricsRegistry
            metrics = MetricsRegistry()
        self.metrics = metrics
        m = metrics
        self._c_requests = m.counter("shadow.requests")
        self._c_evaluated = m.counter("shadow.evaluated")
        self._c_agree = m.counter("shadow.agreements")
        self._c_disagree = m.counter("shadow.disagreements")
        self._c_wins = m.counter("shadow.wins")
        self._c_losses = m.counter("shadow.losses")
        self._c_dropped = m.counter("shadow.dropped")
        self._c_errors = m.counter("shadow.errors")
        self._g_agree = m.gauge("shadow.agreement_rate")
        self._g_win = m.gauge("shadow.win_rate")
        self._h_eval = m.histogram("shadow.eval_s")

        # (structure fingerprint, algorithm) → predicted factorization
        # flops; bounded LRU so a long-lived shadow can't grow unboundedly
        self._flops_cache: "collections.OrderedDict[Tuple[str, str], int]" \
            = collections.OrderedDict()
        self._flops_cache_cap = flops_cache
        self._cache_lock = threading.Lock()

        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, max_queue))
        self._pending = 0
        self._pending_lock = threading.Lock()
        self._closed = False
        self._worker = threading.Thread(target=self._loop,
                                        name="shadow-eval", daemon=True)
        self._worker.start()

    # -- hot-path surface ----------------------------------------------------
    def observe(self, mat, incumbent_algorithm: str,
                key: Optional[str] = None) -> None:
        """Mirror one serving decision to the candidate. Non-blocking,
        never raises: a full queue (or a closed evaluator) drops the
        observation and counts it under ``shadow.dropped``."""
        try:
            self._c_requests.inc()
            if self._closed:
                self._c_dropped.inc()
                return
            with self._pending_lock:
                self._pending += 1
            try:
                self._queue.put_nowait((mat, incumbent_algorithm, key))
            except queue.Full:
                with self._pending_lock:
                    self._pending -= 1
                self._c_dropped.inc()
        except Exception:
            # the mirror must never surface anything into the serving path
            self._c_errors.inc()

    # -- worker --------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is _SENTINEL:
                return
            try:
                self._evaluate(*item)
            except Exception:
                self._c_errors.inc()
            finally:
                with self._pending_lock:
                    self._pending -= 1

    def _evaluate(self, mat, incumbent: str, key: Optional[str]) -> None:
        t0 = time.perf_counter()
        cand, _ = self.selector.select(mat)
        if cand == incumbent:
            self._c_agree.inc()
            self._c_wins.inc()  # matching production is never a regression
        else:
            self._c_disagree.inc()
            key = key if key is not None else matrix_fingerprint(mat)
            f_cand = self._predicted_flops(mat, cand, key)
            f_inc = self._predicted_flops(mat, incumbent, key)
            if f_cand <= f_inc:
                self._c_wins.inc()
            else:
                self._c_losses.inc()
        self._c_evaluated.inc()
        n = self._c_evaluated.value
        self._g_agree.set(self._c_agree.value / n)
        self._g_win.set(self._c_wins.value / n)
        self._h_eval.observe(time.perf_counter() - t0)

    def _predicted_flops(self, mat, algorithm: str, key: str) -> int:
        """Counterfactual cost of serving ``mat`` under ``algorithm``:
        symbolic-factorization flops of the reordered pattern (the same
        cost model ``ExecutionPlan.predicted_flops`` carries). Memoized
        per (structure, algorithm)."""
        ck = (key, algorithm)
        with self._cache_lock:
            if ck in self._flops_cache:
                self._flops_cache.move_to_end(ck)
                return self._flops_cache[ck]
        from ..sparse.csr import permute_symmetric
        from ..sparse.reorder import get_reordering
        from ..sparse.symbolic import symbolic_cholesky

        perm = get_reordering(algorithm)(mat)
        flops = int(symbolic_cholesky(permute_symmetric(mat, perm)).flops)
        with self._cache_lock:
            self._flops_cache[ck] = flops
            while len(self._flops_cache) > self._flops_cache_cap:
                self._flops_cache.popitem(last=False)
        return flops

    # -- readout / lifecycle -------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """Plain-data scorecard (the promotion gate's online evidence)."""
        n = self._c_evaluated.value
        return dict(
            candidate_fingerprint=self.candidate_fingerprint,
            requests=self._c_requests.value, evaluated=n,
            agreements=self._c_agree.value,
            disagreements=self._c_disagree.value,
            wins=self._c_wins.value, losses=self._c_losses.value,
            dropped=self._c_dropped.value, errors=self._c_errors.value,
            agreement_rate=(self._c_agree.value / n) if n else None,
            win_rate=(self._c_wins.value / n) if n else None,
            backlog=self._queue.qsize())

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait until every enqueued observation has been evaluated (or
        dropped); False on timeout. Tests and the promotion path use this
        so the gate reads a settled scorecard."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self._pending_lock:
                if self._pending == 0:
                    return True
            time.sleep(0.002)
        return False

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker (pending observations are still evaluated)."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(_SENTINEL)
        self._worker.join(timeout)

    def __repr__(self) -> str:
        return (f"ShadowEvaluator(candidate="
                f"{self.candidate_fingerprint[:12]}, "
                f"evaluated={self._c_evaluated.value})")
