"""The port's serving primitives against the reference's: request
contexts, the metrics registry, the file lock, and both plan-cache tiers.

The same sequence of operations goes through both packages and must give
equal results: equal metric snapshots (event records equal apart from
their timestamps), equal cache stats dicts (hits, misses, evictions, disk
hits, writes and evictions, entries and bytes under a budget). The port's
disk tier keeps its own file names and unpickles only ``repro_torch.*``,
``numpy.*`` and builtin data types: a subprocess pointed at a directory
holding a reference-written plan under the same key and version gets a
miss and loads neither ``jax`` nor ``repro``.
"""
import json
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import metrics as ref_metrics  # noqa: E402
from repro.core import plan_cache as ref_pc  # noqa: E402
from repro.core import reqctx as ref_reqctx  # noqa: E402
from repro.core.plan import PlanBuilder as RefBuilder  # noqa: E402
from repro.sparse.dataset import grid2d as ref_grid2d  # noqa: E402

from repro_torch.core import metrics, plan_cache, reqctx  # noqa: E402
from repro_torch.core.locking import FileLock  # noqa: E402
from repro_torch.core.plan import PlanBuilder  # noqa: E402
from repro_torch.sparse.dataset import grid2d  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


# ---------------------------------------------------------------------------
# request contexts
# ---------------------------------------------------------------------------

def test_error_names_are_the_references():
    assert set(reqctx.SERVING_ERRORS) == set(ref_reqctx.SERVING_ERRORS)
    for name, cls in reqctx.SERVING_ERRORS.items():
        assert cls.__name__ == name
        assert issubclass(cls, reqctx.ServingError)
        assert issubclass(cls, RuntimeError)
    assert reqctx.__all__ == ref_reqctx.__all__


def test_context_mint_deadline_and_spans():
    a = reqctx.RequestContext.mint()
    b = reqctx.RequestContext.mint(deadline_ms=50.0, priority=3,
                                   request_id="r-1")
    assert a.request_id != b.request_id and b.request_id == "r-1"
    assert a.deadline_s is None and a.remaining() is None
    assert not a.expired() and b.priority == 3
    assert 0.0 < b.remaining() <= 0.050 + 1e-6 and not b.expired()
    c = reqctx.RequestContext.mint(deadline_ms=-1.0)
    assert c.expired() and c.remaining() < 0
    a.add_span("select", 0.010)
    a.add_span("select", 0.005)
    with a.span("build"):
        time.sleep(0.005)
    with pytest.raises(ValueError):
        with a.span("factor"):
            raise ValueError("boom")
    assert a.spans["select"] == pytest.approx(0.015)
    assert a.spans["build"] >= 0.005 and "factor" in a.spans
    assert a.spans_ms()["select"] == pytest.approx(15.0)
    s = b.summary()
    assert set(s) == set(ref_reqctx.RequestContext.mint().summary())
    assert s["request_id"] == "r-1" and s["deadline_remaining_ms"] > 0


def test_context_pickles_without_its_lock():
    ctx = reqctx.RequestContext.mint(deadline_ms=100.0)
    ctx.add_span("cache", 0.001)
    back = pickle.loads(pickle.dumps(ctx))
    assert back.request_id == ctx.request_id and back.spans == ctx.spans
    back.add_span("cache", 0.001)
    assert back.spans["cache"] == pytest.approx(0.002)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _drive(m, reg, sink_cls):
    """One seeded sequence of instrument updates and events."""
    rng = np.random.default_rng(0)
    sink = reg.add_sink(sink_cls())
    for i in range(40):
        reg.counter(f"c.{i % 3}").inc(int(rng.integers(1, 4)))
        reg.gauge("g").set(float(rng.standard_normal()))
        reg.gauge("depth").inc(2)
        reg.gauge("depth").dec(1)
        reg.histogram("stage.x_s").observe(float(rng.random()))
        if i % 7 == 0:
            reg.emit("dispatch.shed", request_id=f"r{i}", late_by_ms=i * 1.5)
    reg.histogram("h.small", window=5)
    for v in range(10):
        reg.histogram("h.small", window=5).observe(v)
    return sink


def test_metrics_equal_snapshots_and_events():
    got = metrics.MetricsRegistry()
    want = ref_metrics.MetricsRegistry()
    s1 = _drive(metrics, got, metrics.ListSink)
    s2 = _drive(ref_metrics, want, ref_metrics.ListSink)
    assert got.snapshot() == want.snapshot()
    strip = [{k: v for k, v in r.items() if k != "t_unix"}
             for r in s1.records]
    assert strip == [{k: v for k, v in r.items() if k != "t_unix"}
                     for r in s2.records]
    assert len(s1) == 6 and all("t_unix" in r for r in s1.records)
    h = got.histogram("h.small")
    assert h.values() == [5.0, 6.0, 7.0, 8.0, 9.0] and h.count == 10
    assert h.percentile(50) == want.histogram("h.small").percentile(50)
    got.reset()
    want.reset()
    assert got.snapshot() == want.snapshot()
    assert got.snapshot()["c.0"] == 0 and got.snapshot()["h.small.count"] == 0


def test_metrics_jsonl_sink_and_failing_sink(tmp_path):
    path = str(tmp_path / "sub" / "m.jsonl")
    reg = metrics.MetricsRegistry([metrics.JSONLSink(path)])

    class Broken(metrics.MetricsSink):
        def emit(self, record):
            raise OSError("disk full")

    reg.add_sink(Broken())
    reg.emit("dispatch.reject", request_id="r0", depth=3,
             obj=object())  # unserializable field: stringified
    reg.close()
    lines = open(path).read().splitlines()
    rec = json.loads(lines[0])
    assert len(lines) == 1 and rec["event"] == "dispatch.reject"
    assert rec["depth"] == 3 and isinstance(rec["obj"], str)
    assert metrics.default_registry() is metrics.default_registry()


def test_metrics_counters_survive_threads():
    reg = metrics.MetricsRegistry()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                reg.counter("n").inc()
                reg.histogram("h").observe(1.0)
        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert reg.counter("n").value == 16000
    assert reg.histogram("h").count == 16000


# ---------------------------------------------------------------------------
# file lock (two instances = two open file descriptions, which flock
# treats as two holders even within one process)
# ---------------------------------------------------------------------------

def test_file_lock_exclusive_shared_and_timed(tmp_path):
    path = str(tmp_path / "d" / ".lock")
    a, b = FileLock(path), FileLock(path)
    with a.exclusive():
        assert b.acquire(blocking=False) is False
        t0 = time.monotonic()
        assert b.acquire(timeout=0.1) is False
        assert time.monotonic() - t0 >= 0.1
        assert b.acquire(blocking=False, shared=True) is False
    assert b.acquire(blocking=False) is True
    b.release()
    with a.shared():
        assert b.acquire(blocking=False, shared=True) is True
        b.release()
        assert b.acquire(blocking=False) is False
    back = pickle.loads(pickle.dumps(a))
    assert back.path == path and back.acquire(timeout=1.0)
    back.release()


# ---------------------------------------------------------------------------
# plan cache: memory tier
# ---------------------------------------------------------------------------

def _memory_sequence(mod, reg):
    cache = mod.PlanCache(capacity=3, metrics=reg)
    out = []
    for k in "abcd":
        cache.put(k, {"v": k})
    out.append(cache.get("a"))          # evicted → miss
    out.append(cache.get("b"))
    cache.put("e", 5)
    out.append(cache.peek("c"))         # no LRU touch, no count
    out.append(cache.get("c"))          # c was evicted by e
    out.append("b" in cache)
    out.append(len(cache))
    return cache, out


def test_memory_tier_equal_stats_and_metrics():
    r1, r2 = metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    got, out1 = _memory_sequence(plan_cache, r1)
    want, out2 = _memory_sequence(ref_pc, r2)
    assert out1 == out2
    assert got.stats() == want.stats()
    assert r1.snapshot() == r2.snapshot()
    assert got.peek("zz") is None and got.stats() == want.stats()
    got.reset_stats()
    assert got.stats()["hits"] == 0 and len(got) == 3


# ---------------------------------------------------------------------------
# plan cache: disk tier
# ---------------------------------------------------------------------------

def _payload(i):
    return {"i": i, "perm": np.arange(40 + i, dtype=np.int64)[::-1].copy()}


def _disk_sequence(mod, d, reg, **budget):
    """Puts, gets, memory evictions, restarts and budget sweeps; mtimes set
    explicitly so the sweep's order does not hang on the clock."""
    c = mod.TwoTierPlanCache(2, str(d), version="sel-x", metrics=reg,
                             **budget)
    log = []
    for i in range(5):
        c.put(f"k{i}", _payload(i))
        p = c._path(f"k{i}")
        if os.path.exists(p):
            os.utime(p, (1e9 + i, 1e9 + i))
    for k in ("k0", "k3", "k4", "k1", "nope"):
        v = c.get(k)
        log.append(None if v is None else int(v["i"]))
    again = mod.TwoTierPlanCache(2, str(d), version="sel-x", **budget)
    log.append(None if again.get("k4") is None else "warm")
    other = mod.TwoTierPlanCache(2, str(d), version="sel-y", **budget)
    log.append(other.get("k4"))
    return c, log


@pytest.mark.parametrize("budget", [
    dict(), dict(max_disk_entries=3),
    dict(max_disk_bytes=3 * len(pickle.dumps(_payload(4), protocol=5)))],
    ids=["unbounded", "entries3", "bytes"])
def test_disk_tier_equal_stats(tmp_path, budget):
    r1, r2 = metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    got, log1 = _disk_sequence(plan_cache, tmp_path / "port", r1, **budget)
    want, log2 = _disk_sequence(ref_pc, tmp_path / "ref", r2, **budget)
    assert log1 == log2
    s1, s2 = got.stats(), want.stats()
    assert s1 == s2, (s1, s2)
    assert r1.snapshot() == r2.snapshot()
    names = sorted(os.listdir(tmp_path / "port"))
    assert all(n.endswith(".sel-x.torchplan.pkl") for n in names
               if not n.startswith("."))
    got.clear_disk()
    assert got.disk_entries() == 0 and got.stats()["disk_bytes"] == 0


def test_disk_tier_misses_on_unreadable_and_foreign_files(tmp_path):
    c = plan_cache.TwoTierPlanCache(4, str(tmp_path), version="v1")
    with open(c._path("bad"), "wb") as f:
        f.write(b"\x80\x05garbage")
    with open(c._path("evil"), "wb") as f:
        pickle.dump(os.getcwd, f)            # names os.getcwd
    with open(c._path("ordered"), "wb") as f:
        pickle.dump(threading.Lock, f)       # names _thread.allocate_lock
    for k in ("bad", "evil", "ordered"):
        assert c.get(k) is None
    assert c.stats()["misses"] == 3 and c.stats()["disk_hits"] == 0
    c.put("evil", {"ok": np.float32(1.5)})   # the next put overwrites
    fresh = plan_cache.TwoTierPlanCache(4, str(tmp_path), version="v1")
    assert fresh.get("evil") == {"ok": np.float32(1.5)}
    with pytest.raises(pickle.UnpicklingError, match="not admitted"):
        plan_cache.restricted_loads(pickle.dumps(eval))
    assert plan_cache.restricted_loads(pickle.dumps(
        [1, 2.0, "s", b"b", (1,), {2}, frozenset({3}), slice(1, 2),
         range(3), complex(1, 2), bytearray(b"x")]))[0] == 1


def test_disk_tier_plans_round_trip_and_write_errors(tmp_path):
    a = grid2d(6, 6, "g6")
    plan = PlanBuilder(device="cpu").build(a, "amd")
    c = plan_cache.TwoTierPlanCache(4, str(tmp_path), version="v1")
    c.put(plan.fingerprint, plan)
    back = plan_cache.TwoTierPlanCache(4, str(tmp_path),
                                       version="v1").get(plan.fingerprint)
    assert back.algorithm == plan.algorithm
    np.testing.assert_array_equal(back.perm, plan.perm)
    np.testing.assert_array_equal(back.sym.Li, plan.sym.Li)
    c.put("lambda", lambda: 0)               # unpicklable: memory only
    s = c.stats()
    assert s["disk_errors"] == 1 and s["disk_writes"] == 1
    assert c.get("lambda")() == 0


_ISOLATED = r"""
import json, sys
from repro_torch.core.plan_cache import TwoTierPlanCache
key, out = sys.argv[1], {}
for d in sys.argv[2:]:
    c = TwoTierPlanCache(8, d, version="sel-0123456789abcdef")
    out[d] = [c.get(key) is None, c.stats()["misses"], c.stats()["disk_hits"]]
out["loaded"] = sorted(m for m in sys.modules if m.split(".")[0] in
                       ("jax", "repro", "jaxlib"))
print(json.dumps(out))
"""


def test_reference_written_plan_is_a_miss_that_loads_no_reference(tmp_path):
    a = ref_grid2d(7, 7, "g7")
    plan = RefBuilder().build(a, "amd")
    key = ref_pc.matrix_fingerprint(a)
    assert key == plan_cache.matrix_fingerprint(grid2d(7, 7, "g7"))
    own, foreign = tmp_path / "own", tmp_path / "foreign"
    ref = ref_pc.TwoTierPlanCache(8, str(own), version="sel-0123456789abcdef")
    ref.put(key, plan)
    assert type(ref._tier_load(key)).__module__ == "repro.core.plan"
    # the same bytes under the port's own file name
    os.makedirs(foreign)
    port = plan_cache.TwoTierPlanCache(8, str(foreign),
                                       version="sel-0123456789abcdef")
    with open(ref._path(key), "rb") as src, open(port._path(key), "wb") as d:
        d.write(src.read())
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", _ISOLATED, key, str(own),
                        str(foreign)], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out[str(own)] == [True, 1, 0]
    assert out[str(foreign)] == [True, 1, 0]
    assert out["loaded"] == []
