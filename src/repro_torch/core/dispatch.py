"""Port of ``repro/core/dispatch.py`` (:57-493): :class:`PlanDispatcher`,
the serving plane's transport-agnostic batching core.

The in-process server (:class:`repro_torch.launch.serve_selector
.AsyncPlanServer`), the RPC front-end (:mod:`repro_torch.launch.rpc`) and
tests push requests into the same core and get back futures of
:class:`repro_torch.core.plan.ExecutionPlan`. Every request travels as a
:class:`~repro_torch.core.reqctx.RequestContext` (minted at ``submit``
when the caller brought none), and on it the dispatcher implements:

* **Admission control** — ``max_queue`` bounds the queue; a submit against
  a full queue raises :class:`~repro_torch.core.reqctx.QueueFull`.
* **Deadline shedding** — an expired request fails with
  :class:`~repro_torch.core.reqctx.DeadlineExceeded` at dequeue time (the
  batcher drops it before featurization) or before its build (a build
  worker prunes expired waiters first), so it never occupies a worker.
  Warm cache hits are served even past their deadline.
* **Priority batching** — higher ``ctx.priority`` first, FIFO within one.
* **Structured metrics** — ``dispatch.*`` counters and gauges and
  ``stage.*`` latency histograms in a
  :class:`~repro_torch.core.metrics.MetricsRegistry`; ``stats()`` reads
  the same instruments.

Pipeline:

* ``submit`` fingerprints the matrix; a cache hit resolves the future at
  once, a miss is admitted (or rejected) into the priority queue.
* One **batcher** thread collects misses until ``batch_size`` are waiting
  or the oldest has aged ``max_wait_ms``, sheds expired ones, groups them
  by fingerprint, joins keys whose build is already in flight, re-checks
  the memory tier (a sibling batch may have built the plan meanwhile) and
  runs ``PlanBuilder.select_names`` over the rest: the padded CSR batch is
  uploaded, featurized by the ``entry_stats`` / ``row_stats`` kernels and
  classified on the card.
* ``build_workers`` **builder** threads take (key, algorithm) items, prune
  expired waiters, run reorder + symbolic analysis on the host, install the
  plan in the shared cache and resolve every waiter of that key, so the
  builds of one micro-batch overlap the next one's selection.

A failure of the selection or of a build fails the futures it concerns with
that exception; nothing falls back to another device or path. ``close()``
fails every queued request and every waiter of an unstarted build with
:class:`~repro_torch.core.reqctx.DispatcherClosed`: no future hangs.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

from ..sparse.csr import CSRMatrix
from .metrics import MetricsRegistry
from .plan import ExecutionPlan, PlanBuilder
from .plan_cache import matrix_fingerprint
from .reqctx import (DeadlineExceeded, DispatcherClosed, QueueFull,
                     RequestContext)

__all__ = ["PlanDispatcher"]

_SENTINEL = object()


class _PlanRequest:
    """One queued request: the matrix, its context, and its future."""

    __slots__ = ("mat", "key", "ctx", "future", "t_enqueue")

    def __init__(self, mat: CSRMatrix, key: str, ctx: RequestContext,
                 future: "Future[ExecutionPlan]"):
        self.mat = mat
        self.key = key
        self.ctx = ctx
        self.future = future
        self.t_enqueue = time.perf_counter()


class PlanDispatcher:
    """Request queue → deadline micro-batches → staged cold path.

    See the module docstring for the pipeline shape and serving
    disciplines. Thread-safe: any number of front-end threads (in-process
    callers, RPC connection handlers) may ``submit`` concurrently.

    ``max_queue=None`` keeps the queue unbounded; ``default_deadline_ms`` stamps a deadline on requests whose
    minted context has none (caller-supplied contexts are never altered).
    """

    def __init__(self, builder: PlanBuilder, *, batch_size: int = 16,
                 max_wait_ms: float = 5.0, build_workers: int = 2,
                 latency_window: int = 100_000,
                 max_queue: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 shadow=None):
        if builder.selector is None:
            raise ValueError("the cold path needs a selector")
        self.builder = builder
        # shadow mirror: a duck-typed observer with ``observe(mat,
        # algorithm, key=...)`` (the lifecycle's shadow evaluator), or a
        # zero-arg provider returning one or None so shadowing can start and
        # stop while this dispatcher is live; every resolved decision is
        # mirrored to it off the hot path, never consulted for the response
        self._shadow = shadow
        self.cache = builder.cache
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1e3
        self.max_queue = max_queue
        self.default_deadline_ms = default_deadline_ms
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        m = self.metrics
        self._c_requests = m.counter("dispatch.requests")
        self._c_warm = m.counter("dispatch.warm_hits")
        self._c_shed = m.counter("dispatch.shed")
        self._c_rejected = m.counter("dispatch.rejected")
        self._c_closed = m.counter("dispatch.closed_rejects")
        self._c_errors = m.counter("dispatch.errors")
        self._g_depth = m.gauge("dispatch.queue_depth")
        self._g_inflight = m.gauge("dispatch.inflight_keys")
        self._h_latency = m.histogram("dispatch.latency_s", latency_window)
        self._h_queue = m.histogram("stage.queue_s", latency_window)
        self._h_select = m.histogram("stage.select_s", latency_window)
        self._h_build = m.histogram("stage.build_s", latency_window)
        # priority queue entries: (-priority, seq, request-or-sentinel) —
        # higher priority first, FIFO within a priority via the sequence
        # number (which also keeps requests themselves out of comparisons)
        self._seq = itertools.count()
        self._queue: "queue.PriorityQueue" = queue.PriorityQueue(
            maxsize=max_queue or 0)
        self._build_queue: "queue.Queue" = queue.Queue()
        # keys whose plan build is in flight → requests waiting on it, so a
        # later micro-batch joins the pending build instead of duplicating
        # the selection + build work (guarded by _inflight_lock; builders
        # cache.put *before* popping, so a racer either finds the in-flight
        # entry or peeks the finished plan — never neither)
        self._inflight_lock = threading.Lock()
        self._inflight: Dict[str, List[_PlanRequest]] = {}
        # serializes enqueue-vs-shutdown so no request can land behind the
        # sentinel with a forever-pending future
        self._close_lock = threading.Lock()
        self._closed = False
        self._batcher = threading.Thread(target=self._batch_loop,
                                         name="plan-batcher", daemon=True)
        self._builders = [threading.Thread(target=self._build_loop,
                                           name=f"plan-builder-{i}",
                                           daemon=True)
                          for i in range(max(1, build_workers))]
        self._batcher.start()
        for t in self._builders:
            t.start()

    def set_shadow(self, shadow) -> None:
        """Install (or clear, with None) the shadow mirror at runtime."""
        self._shadow = shadow

    def _mirror(self, mat: CSRMatrix, algorithm: str, key: str) -> None:
        """Hand one resolved decision to the shadow evaluator, if any.
        ``observe`` is O(enqueue) and never raises — the mirror can only
        drop observations, never slow or fail the serving path."""
        shadow = self._shadow
        if callable(shadow) and not hasattr(shadow, "observe"):
            shadow = shadow()
        if shadow is not None:
            shadow.observe(mat, algorithm, key=key)

    # -- client surface ------------------------------------------------------
    def submit(self, mat: CSRMatrix,
               ctx: Optional[RequestContext] = None
               ) -> "Future[ExecutionPlan]":
        """Future of the plan for ``mat``; the request's context rides on
        the returned future as ``fut.ctx`` (span timings, identity).

        Raises :class:`QueueFull` (queue at ``max_queue``) or
        :class:`DispatcherClosed` at admission; a deadline that expires
        *later* fails the future with :class:`DeadlineExceeded` instead.
        """
        if ctx is None:
            ctx = RequestContext.mint(deadline_ms=self.default_deadline_ms)
        self._c_requests.inc()
        fut: "Future[ExecutionPlan]" = Future()
        fut.ctx = ctx  # type: ignore[attr-defined]
        with ctx.span("cache"):
            ctx.fingerprint = key = matrix_fingerprint(mat)
            plan = self.cache.get(key)
        if plan is not None:
            # the warm path serves even expired deadlines: the answer is
            # already in hand, failing it would only hurt the client
            self._c_warm.inc()
            self._finish(ctx)
            fut.set_result(plan)
            self._mirror(mat, plan.algorithm, key)
            return fut
        if ctx.expired():
            self._shed(_PlanRequest(mat, key, ctx, fut))
            return fut
        with self._close_lock:
            if self._closed:
                self._c_closed.inc()
                raise DispatcherClosed("dispatcher is closed")
            entry = (-ctx.priority, next(self._seq),
                     _PlanRequest(mat, key, ctx, fut))
            try:
                self._queue.put_nowait(entry)
            except queue.Full:
                self._c_rejected.inc()
                self.metrics.emit("dispatch.reject",
                                  request_id=ctx.request_id,
                                  fingerprint=key, depth=self._queue.qsize())
                raise QueueFull(
                    f"dispatch queue at capacity ({self.max_queue}); "
                    f"request {ctx.request_id} rejected") from None
        self._g_depth.set(self._queue.qsize())
        return fut

    def handle(self, mats: Sequence[CSRMatrix], timeout: float = 120.0,
               ctxs: Optional[Sequence[RequestContext]] = None
               ) -> List[ExecutionPlan]:
        if ctxs is None:
            ctxs = [None] * len(mats)  # type: ignore[list-item]
        futs = [self.submit(m, c) for m, c in zip(mats, ctxs)]
        return [f.result(timeout=timeout) for f in futs]

    def close(self, timeout: float = 30.0) -> None:
        """Drain and stop. Every request still queued or waiting on an
        unstarted build is failed with :class:`DispatcherClosed` — clients
        get a typed error, never a hung future. ``timeout`` bounds each
        thread join."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            # fail everything still in the queue (nothing new can land:
            # submit checks _closed under this same lock)
            pending: List[_PlanRequest] = []
            while True:
                try:
                    entry = self._queue.get_nowait()
                except queue.Empty:
                    break
                if entry[2] is not _SENTINEL:
                    pending.append(entry[2])
            self._queue.put((float("inf"), next(self._seq), _SENTINEL))
        exc = DispatcherClosed("dispatcher closed before the request "
                               "was served")
        for r in pending:
            self._c_closed.inc()
            self._fail(r, exc)
        self._batcher.join(timeout)
        for t in self._builders:
            t.join(timeout)
        # builds already queued were finished by the workers before their
        # sentinel; anything still in _inflight had no build queued — fail
        # those waiters too rather than leaving them pending forever
        with self._inflight_lock:
            leftovers = [r for reqs in self._inflight.values() for r in reqs]
            self._inflight.clear()
        for r in leftovers:
            self._c_closed.inc()
            self._fail(r, exc)
        self._g_depth.set(0)
        self._g_inflight.set(0)

    def reset_stats(self) -> None:
        """Zero the serving metrics (latency windows, counters, builder +
        cache counters) — e.g. after an untimed warm-up, so the reported
        numbers reflect steady-state serving only."""
        self.metrics.reset()
        self.builder.reset_stats()  # resets the cache counters too

    def stats(self) -> dict:
        s = self.builder.stats()
        s.update(requests=self._c_requests.value,
                 warm_hits=self._c_warm.value,
                 shed=self._c_shed.value,
                 rejected=self._c_rejected.value,
                 closed_rejects=self._c_closed.value,
                 errors=self._c_errors.value,
                 queue_depth=self._queue.qsize(),
                 max_queue=self.max_queue)
        with self._inflight_lock:
            s["inflight_keys"] = len(self._inflight)
        lat = self._h_latency.summary()
        if lat["count"]:
            s.update(p50_ms=lat["p50"] * 1e3, p99_ms=lat["p99"] * 1e3,
                     mean_ms=lat["mean"] * 1e3)
        for stage, h in (("queue", self._h_queue),
                         ("select", self._h_select),
                         ("build", self._h_build)):
            hs = h.summary()
            if hs["count"]:
                s[f"stage_{stage}_p50_ms"] = hs["p50"] * 1e3
                s[f"stage_{stage}_p99_ms"] = hs["p99"] * 1e3
        return s

    # -- request completion helpers ------------------------------------------
    def _finish(self, ctx: RequestContext) -> None:
        """Record end-to-end latency and the total span."""
        dt = ctx.elapsed()
        ctx.add_span("total", dt - ctx.spans.get("total", 0.0))
        self._h_latency.observe(dt)

    def _fail(self, r: _PlanRequest, exc: BaseException) -> None:
        self._finish(r.ctx)
        if not r.future.set_running_or_notify_cancel():
            return  # client cancelled; nothing to deliver
        r.future.set_exception(exc)

    def _shed(self, r: _PlanRequest) -> None:
        self._c_shed.inc()
        self.metrics.emit("dispatch.shed", request_id=r.ctx.request_id,
                          fingerprint=r.key,
                          late_by_ms=-(r.ctx.remaining() or 0.0) * 1e3)
        self._fail(r, DeadlineExceeded(
            f"request {r.ctx.request_id} missed its deadline by "
            f"{-(r.ctx.remaining() or 0.0) * 1e3:.1f} ms"))

    def _resolve(self, r: _PlanRequest, plan: ExecutionPlan) -> None:
        self._finish(r.ctx)
        if not r.future.set_running_or_notify_cancel():
            return
        r.future.set_result(plan)

    # -- stage 1: micro-batcher (feature-batch + device inference) -----------
    def _take(self, timeout: Optional[float]) -> object:
        """One queue entry → request (shedding expired ones) or sentinel;
        raises queue.Empty on timeout."""
        while True:
            if timeout is None:
                entry = self._queue.get()
            else:
                entry = self._queue.get(timeout=timeout)
            self._g_depth.set(self._queue.qsize())
            item = entry[2]
            if item is _SENTINEL:
                return _SENTINEL
            r: _PlanRequest = item
            waited = time.perf_counter() - r.t_enqueue
            r.ctx.add_span("queue", waited)
            self._h_queue.observe(waited)
            if r.ctx.expired():
                # deadline shedding at dequeue: the client stopped waiting,
                # so spend nothing further on this request
                self._shed(r)
                continue
            return r

    def _batch_loop(self) -> None:
        stop = False
        while not stop:
            try:
                item = self._take(None)
            except queue.Empty:  # pragma: no cover - blocking get
                continue
            if item is _SENTINEL:
                break
            batch: List[_PlanRequest] = [item]
            deadline = time.perf_counter() + self.max_wait
            while len(batch) < self.batch_size:
                remain = deadline - time.perf_counter()
                if remain <= 0:
                    break
                try:
                    nxt = self._take(remain)
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    stop = True
                    break
                batch.append(nxt)
            self._dispatch(batch)
        self._build_queue.put(_SENTINEL)

    def _dispatch(self, batch: List[_PlanRequest]) -> None:
        groups: Dict[str, List[_PlanRequest]] = {}
        for r in batch:
            groups.setdefault(r.key, []).append(r)
        todo: List[str] = []
        for key, reqs in groups.items():
            with self._inflight_lock:
                pending = self._inflight.get(key)
                if pending is not None:
                    pending.extend(reqs)  # join the build already in flight
                    continue
                plan = self.cache.peek(key)  # a sibling may have built it
                if plan is None:
                    self._inflight[key] = reqs
                    todo.append(key)
            if plan is not None:
                for r in reqs:
                    self._resolve(r, plan)
        self._g_inflight.set(len(self._inflight))
        if not todo:
            return
        t0 = time.perf_counter()
        try:
            names = self.builder.select_names(
                [self._inflight[key][0].mat for key in todo])
        except Exception as exc:  # selector failure fails the whole batch
            self._c_errors.inc()
            for key in todo:
                with self._inflight_lock:
                    reqs = self._inflight.pop(key, [])
                for r in reqs:
                    self._fail(r, exc)
            return
        dt = time.perf_counter() - t0
        self._h_select.observe(dt)
        for key in todo:
            # selection ran once over the whole micro-batch; attribute its
            # wall time to every member (it gated each of them equally)
            with self._inflight_lock:
                reqs = list(self._inflight.get(key, ()))
            for r in reqs:
                r.ctx.add_span("select", dt)
        for key, name in zip(todo, names):
            with self._inflight_lock:
                reqs = self._inflight.get(key)
                rep = reqs[0].mat if reqs else None
            if rep is not None:
                self._mirror(rep, name, key)
            self._build_queue.put((key, name))

    # -- stage 2: plan build (reorder + symbolic) ----------------------------
    def _prune_expired(self, key: str) -> Tuple[List[_PlanRequest], bool]:
        """Shed expired waiters for ``key``. Returns (shed, any_live):
        when no waiter is still live, the key is popped from _inflight and
        the build is skipped entirely — an expired request never occupies
        a build worker."""
        with self._inflight_lock:
            reqs = self._inflight.get(key)
            if not reqs:
                self._inflight.pop(key, None)
                return [], False
            live = [r for r in reqs if not r.ctx.expired()]
            dead = [r for r in reqs if r.ctx.expired()]
            if live:
                self._inflight[key] = live
            else:
                self._inflight.pop(key, None)
        return dead, bool(live)

    def _build_loop(self) -> None:
        while True:
            item = self._build_queue.get()
            if item is _SENTINEL:
                self._build_queue.put(_SENTINEL)  # release sibling workers
                return
            key, name = item
            dead, any_live = self._prune_expired(key)
            for r in dead:
                self._shed(r)
            if not any_live:
                continue  # every waiter expired: no build worker consumed
            mat = self._inflight[key][0].mat  # entry exists until we pop it
            rep_ctx = self._inflight[key][0].ctx  # per-stage reorder/symbolic
            t0 = time.perf_counter()
            try:
                plan = self.builder.build(mat, algorithm=name,
                                          fingerprint=key, ctx=rep_ctx)
            except Exception as exc:
                self._c_errors.inc()
                with self._inflight_lock:
                    reqs = self._inflight.pop(key, [])
                for r in reqs:
                    self._fail(r, exc)
                continue
            dt = time.perf_counter() - t0
            self._h_build.observe(dt)
            try:
                self.cache.put(key, plan)  # put, *then* pop (see _inflight)
            except Exception:
                # a disk-tier write failure must not fail the waiters: the
                # build succeeded and the memory tier is already populated
                pass
            with self._inflight_lock:
                reqs = self._inflight.pop(key, [])
            self._g_inflight.set(len(self._inflight))
            for r in reqs:
                r.ctx.add_span("build", dt)
                self._resolve(r, plan)
