"""Port of ``repro/core/reqctx.py`` (:49-170): :class:`RequestContext`,
one identity for a request across every serving layer, and the typed
serving errors.

A context is minted once at the edge (the RPC wire protocol carries
optional ``request_id``/``deadline_ms``/``priority`` fields;
``SolverEngine.plan/solve`` and ``PlanDispatcher.submit`` mint one when
the caller did not) and threaded through

    PlanRPCServer → PlanDispatcher → PlanBuilder → plan cache → solve

accumulating **span timings** (stage name → seconds), so a ``plan``
response reports where its milliseconds went and the dispatcher can *shed*
a request whose deadline has passed instead of spending a build worker on
it.

The typed serving errors are the vocabulary every layer shares, and the
RPC client re-raises them by name, so their class names are the wire names
and equal the reference's letter for letter:

* :class:`DeadlineExceeded` — the deadline passed before a plan (or a
  factorization) could be produced;
* :class:`QueueFull` — admission control rejected the request: the
  dispatch queue is at ``max_queue``;
* :class:`DispatcherClosed` — the dispatcher shut down; pending futures
  fail with this instead of hanging.

Deadlines are **absolute** ``time.perf_counter()`` instants, converted from
the relative ``deadline_ms`` at mint time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
import uuid
from typing import Dict, Optional

__all__ = ["RequestContext", "ServingError", "DeadlineExceeded",
           "QueueFull", "DispatcherClosed", "SERVING_ERRORS"]


class ServingError(RuntimeError):
    """Base of the typed serving-path errors (wire name = class name)."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before its plan was produced."""


class QueueFull(ServingError):
    """Admission control: the dispatch queue is at capacity."""


class DispatcherClosed(ServingError):
    """The dispatcher shut down; the request cannot be served."""


#: wire name → class, used by the RPC client to re-raise the exact typed
#: error the server-side dispatcher raised (``error_type`` in error frames)
SERVING_ERRORS: Dict[str, type] = {
    cls.__name__: cls
    for cls in (ServingError, DeadlineExceeded, QueueFull, DispatcherClosed)
}

# request ids are "req-<8 hex>-<seq>": unique within a process by the
# counter, unique across processes by the random prefix — and cheap (no
# per-request uuid4 syscall on the hot path)
_ID_PREFIX = uuid.uuid4().hex[:8]
_ID_SEQ = itertools.count()


@dataclasses.dataclass
class RequestContext:
    """Identity + budget + telemetry for one serving request.

    ``spans`` maps a stage name (``queue``, ``select``, ``reorder``,
    ``symbolic``, ``build``, ``cache``, ``permute``, ``factor``, ``solve``,
    ``total``) to accumulated seconds; re-entering a stage adds to it.
    ``deadline_s`` is an absolute :func:`time.perf_counter` instant or
    ``None`` (no deadline). ``priority`` — higher is served first; ties
    are FIFO.
    """

    request_id: str
    fingerprint: Optional[str] = None
    priority: int = 0
    t_arrival: float = dataclasses.field(default_factory=time.perf_counter)
    deadline_s: Optional[float] = None
    spans: Dict[str, float] = dataclasses.field(default_factory=dict)
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    # spans may be written from the batcher thread while (e.g.) an RPC
    # handler thread snapshots them for a response frame
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    # -- construction --------------------------------------------------------
    @classmethod
    def mint(cls, *, request_id: Optional[str] = None,
             deadline_ms: Optional[float] = None, priority: int = 0,
             fingerprint: Optional[str] = None) -> "RequestContext":
        """New context; ``deadline_ms`` is relative-to-now at mint time."""
        now = time.perf_counter()
        return cls(
            request_id=(request_id if request_id
                        else f"req-{_ID_PREFIX}-{next(_ID_SEQ)}"),
            fingerprint=fingerprint, priority=int(priority), t_arrival=now,
            deadline_s=(None if deadline_ms is None
                        else now + float(deadline_ms) / 1e3))

    # -- deadline ------------------------------------------------------------
    def remaining(self) -> Optional[float]:
        """Seconds until the deadline (negative if past); None = no deadline."""
        if self.deadline_s is None:
            return None
        return self.deadline_s - time.perf_counter()

    def expired(self) -> bool:
        return (self.deadline_s is not None
                and time.perf_counter() >= self.deadline_s)

    def elapsed(self) -> float:
        """Seconds since arrival (mint time)."""
        return time.perf_counter() - self.t_arrival

    # -- span telemetry ------------------------------------------------------
    def add_span(self, stage: str, seconds: float) -> None:
        with self._lock:
            self.spans[stage] = self.spans.get(stage, 0.0) + float(seconds)

    @contextlib.contextmanager
    def span(self, stage: str):
        """``with ctx.span("symbolic"): ...`` — accumulate wall time, even
        when the body raises (the time was still spent on this request)."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.add_span(stage, time.perf_counter() - t0)

    def spans_ms(self) -> Dict[str, float]:
        """Wire-friendly copy: stage → milliseconds."""
        with self._lock:
            return {k: v * 1e3 for k, v in self.spans.items()}

    def summary(self) -> Dict[str, object]:
        """Plain-data description (RPC responses, JSONL metric events)."""
        return dict(request_id=self.request_id, fingerprint=self.fingerprint,
                    priority=self.priority,
                    deadline_remaining_ms=(None if self.deadline_s is None
                                           else self.remaining() * 1e3),
                    spans_ms=self.spans_ms())

    # contexts travel inside futures between threads but never across
    # processes; strip the lock if something pickles one anyway
    def __getstate__(self):
        state = self.__dict__.copy()
        state.pop("_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()
