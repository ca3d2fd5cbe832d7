"""Port of ``repro/core/metrics.py`` (:40-341): structured serving
metrics — one registry, three instruments, pluggable sinks.

Every serving layer reports in one vocabulary:

* :class:`Counter` — monotonically increasing (requests, sheds, hits);
* :class:`Gauge` — instantaneous level (queue depth, in-flight builds);
* :class:`Histogram` — bounded sliding-window observations with
  percentiles (per-stage latency).

A :class:`MetricsRegistry` hands out get-or-create instruments by dotted
name and snapshots everything into one flat dict (pull); an optional push
channel, ``registry.emit(event, **fields)``, writes one structured record
per event to every attached :class:`MetricsSink` — :class:`JSONLSink`
appends one JSON line per event, :class:`ListSink` captures records for
tests. Stdlib only. Instrument creation is serialized by the registry
lock; each instrument carries its own lock, so the RPC handler threads, the
batcher and the build workers never contend on one global lock.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Sequence

__all__ = ["Counter", "Gauge", "Histogram", "MetricsSink", "NullSink",
           "ListSink", "JSONLSink", "MetricsRegistry", "default_registry"]


class Counter:
    """Monotonic counter. ``inc`` only — a counter that goes down is a
    gauge (``reset`` exists for test/benchmark re-zeroing, not serving)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Instantaneous level: set/inc/dec."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        self.set(0.0)


class Histogram:
    """Sliding-window observations with percentile readout.

    The window (default 100k) bounds memory on a long-running server —
    percentiles describe *recent* behavior, which is what an operator
    wants; lifetime totals survive in ``count``/``sum``.
    """

    __slots__ = ("name", "window", "_obs", "_count", "_sum", "_lock")

    def __init__(self, name: str, window: int = 100_000):
        self.name = name
        self.window = window
        self._obs: Deque[float] = collections.deque(maxlen=window)
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._obs.append(float(v))
            self._count += 1
            self._sum += float(v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def values(self) -> List[float]:
        with self._lock:
            return list(self._obs)

    def percentile(self, q: float) -> float:
        """q in [0, 100]; 0.0 when empty (nearest-rank on the window)."""
        with self._lock:
            if not self._obs:
                return 0.0
            data = sorted(self._obs)
        rank = max(0, min(len(data) - 1,
                          int(round(q / 100.0 * (len(data) - 1)))))
        return data[rank]

    def summary(self) -> Dict[str, float]:
        with self._lock:
            data = sorted(self._obs)
            count, total = self._count, self._sum
        if not data:
            return dict(count=count, sum=total, p50=0.0, p99=0.0, mean=0.0)

        def pct(q: float) -> float:
            return data[max(0, min(len(data) - 1,
                                   int(round(q / 100.0 * (len(data) - 1)))))]

        return dict(count=count, sum=total, p50=pct(50.0), p99=pct(99.0),
                    mean=sum(data) / len(data))

    def reset(self) -> None:
        with self._lock:
            self._obs.clear()
            self._count = 0
            self._sum = 0.0


# ---------------------------------------------------------------------------
# sinks — the push channel for structured events
# ---------------------------------------------------------------------------

class MetricsSink:
    """Receives structured event records (plain dicts)."""

    def emit(self, record: Dict[str, Any]) -> None:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullSink(MetricsSink):
    def emit(self, record: Dict[str, Any]) -> None:
        pass


class ListSink(MetricsSink):
    """In-memory capture (tests, the traffic-replay report)."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def emit(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self.records.append(record)

    def __len__(self) -> int:
        with self._lock:
            return len(self.records)


class JSONLSink(MetricsSink):
    """One JSON object per line, appended; flush-per-event so a crashed
    server loses at most the event in flight. Unserializable fields are
    stringified rather than dropping the record."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")

    def emit(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, default=str)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Get-or-create instruments by dotted name + event fan-out to sinks.

    One registry per serving stack (the engine owns it and threads it into
    the cache, builder, dispatcher, and RPC server) — names are therefore
    scoped by layer prefix (``dispatch.``, ``cache.``, ``rpc.``,
    ``stage.``), not by label sets.
    """

    def __init__(self, sinks: Optional[Sequence[MetricsSink]] = None):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._sinks: List[MetricsSink] = list(sinks or [])

    # -- instruments ---------------------------------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str, window: int = 100_000) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, window)
            return h

    # -- sinks ---------------------------------------------------------------
    def add_sink(self, sink: MetricsSink) -> MetricsSink:
        with self._lock:
            self._sinks.append(sink)
        return sink

    def remove_sink(self, sink: MetricsSink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    def emit(self, event: str, **fields: Any) -> None:
        """Push one structured event record to every sink. A sink failure
        (disk full under the JSONL sink) never fails the serving request
        that emitted the event."""
        with self._lock:
            sinks = list(self._sinks)
        if not sinks:
            return
        record = {"event": event, "t_unix": time.time(), **fields}
        for s in sinks:
            try:
                s.emit(record)
            except Exception:
                pass

    # -- readout -------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Flat dict: counters/gauges by name, histograms as
        ``name.count/.p50/.p99/.mean/.sum`` (milliseconds stay whatever
        unit the observer used — the serving path observes seconds and
        converts at the edge)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
        out: Dict[str, Any] = {}
        for name, c in sorted(counters.items()):
            out[name] = c.value
        for name, g in sorted(gauges.items()):
            out[name] = g.value
        for name, h in sorted(hists.items()):
            s = h.summary()
            for k in ("count", "p50", "p99", "mean", "sum"):
                out[f"{name}.{k}"] = s[k]
        return out

    def reset(self) -> None:
        """Zero every instrument (sinks are untouched)."""
        with self._lock:
            instruments = (list(self._counters.values())
                           + list(self._gauges.values())
                           + list(self._histograms.values()))
        for i in instruments:
            i.reset()

    def close(self) -> None:
        with self._lock:
            sinks = list(self._sinks)
        for s in sinks:
            try:
                s.close()
            except Exception:
                pass


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """Process-wide fallback registry, for layers constructed without an
    engine (ad-hoc dispatchers in tests/scripts)."""
    return _DEFAULT
