"""The port's dispatcher, ``SolverEngine.serve`` and the factorization's
deadline checks, held against the reference's.

Stub selectors whose timing the test controls (one gated on an event, one
that sleeps) make queue-full rejection, shedding at submit, at dequeue and
before a build, priority order, ``close()`` and failures in the batcher or
a build deterministic, as the reference's ``tests/test_backpressure.py``
does; each scenario runs on both packages and must end alike (errors by
wire name, counters, order). Then trained engines with equal fingerprints
serve one seeded serial stream on the device path (CPU here) with the same
names, permutations and counters; a second engine over the same disk tier
is served from disk; and an expired request context stops the
``batched`` and ``pipelined`` factorizations with ``DeadlineExceeded``.
Every blocking call has a timeout.
"""
import os
import socket
import threading
import time
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dispatch as ref_dispatch  # noqa: E402
from repro.core import plan as ref_plan  # noqa: E402
from repro.core import plan_cache as ref_pc  # noqa: E402
from repro.core import reqctx as ref_reqctx  # noqa: E402
from repro.core.labeling import LabeledDataset as RefDataset  # noqa: E402
from repro.engine import EngineConfig as RefConfig  # noqa: E402
from repro.engine import SolverEngine as RefEngine  # noqa: E402
from repro.sparse import multifrontal as ref_mf  # noqa: E402
from repro.sparse.dataset import generate_suite as ref_suite  # noqa: E402
from repro.sparse.dataset import grid2d as ref_grid2d  # noqa: E402

from repro_torch.core import dispatch, plan, plan_cache, reqctx  # noqa: E402
from repro_torch.core.labeling import LabeledDataset  # noqa: E402
from repro_torch.engine import EngineConfig, SolverEngine  # noqa: E402
from repro_torch.sparse import multifrontal as mf  # noqa: E402
from repro_torch.sparse.dataset import generate_suite, grid2d  # noqa: E402

LABELS = "artifacts/labels_c36_s7_x0.35_r1.npz"
SUITE = dict(count=8, seed=3, size_scale=0.25)
T = 60  # seconds: the bound of every blocking call

REF = types.SimpleNamespace(
    Dispatcher=ref_dispatch.PlanDispatcher, Builder=ref_plan.PlanBuilder,
    Cache=ref_pc.PlanCache, key=ref_pc.matrix_fingerprint, ctx=ref_reqctx,
    builder_kw={}, suite=ref_suite)
PORT = types.SimpleNamespace(
    Dispatcher=dispatch.PlanDispatcher, Builder=plan.PlanBuilder,
    Cache=plan_cache.PlanCache, key=plan_cache.matrix_fingerprint,
    ctx=reqctx, builder_kw=dict(device="cpu"), suite=generate_suite)


class _Gated:
    """Holds the first ``select_batch`` until ``release`` is set; records
    the order in which matrices reach selection."""

    def __init__(self, key):
        self.key = key
        self.entered = threading.Event()
        self.release = threading.Event()
        self.order = []
        self._calls = 0

    def select_batch(self, batch, path="host", **kw):
        self._calls += 1
        self.order.extend(self.key(m) for m in batch)
        if self._calls == 1:
            self.entered.set()
            self.release.wait(T)
        return ["amd"] * len(batch), 0.0

    def select(self, a):
        return "amd", 0.0


class _Sleepy:
    def __init__(self, delay, name="amd"):
        self.delay, self.name = delay, name

    def select_batch(self, batch, path="host", **kw):
        time.sleep(self.delay)
        return [self.name] * len(batch), self.delay

    def select(self, a):
        return self.name, 0.0


class _Broken:
    def select_batch(self, batch, path="host", **kw):
        raise RuntimeError("featurizer failed")

    def select(self, a):
        raise RuntimeError("featurizer failed")


def _dispatcher(pkg, selector, **kw):
    builder = pkg.Builder(selector, pkg.Cache(64), batch_size=4, path="host",
                          **pkg.builder_kw)
    kw.setdefault("batch_size", 1)
    kw.setdefault("max_wait_ms", 1.0)
    kw.setdefault("build_workers", 1)
    return pkg.Dispatcher(builder, **kw)


def _outcome(fut):
    try:
        return fut.result(timeout=T).algorithm
    except Exception as exc:  # the typed error, by wire name
        return type(exc).__name__


def _counts(d):
    s = d.stats()
    return {k: s[k] for k in ("requests", "warm_hits", "shed", "rejected",
                              "closed_rejects", "errors", "plans_built",
                              "select_calls", "hits", "misses")}


def _queue_full(pkg, mats):
    sel = _Gated(pkg.key)
    d = _dispatcher(pkg, sel, max_queue=2)
    try:
        futs = [d.submit(mats[0])]
        assert sel.entered.wait(T)
        futs += [d.submit(mats[1]), d.submit(mats[2])]
        try:
            d.submit(mats[3])
            rejected = None
        except pkg.ctx.ServingError as exc:
            rejected = type(exc).__name__
        sel.release.set()
        return dict(rejected=rejected, got=[_outcome(f) for f in futs],
                    counts=_counts(d))
    finally:
        sel.release.set()
        d.close(timeout=T)


def _expired_at_submit(pkg, mats):
    d = _dispatcher(pkg, _Sleepy(0.0))
    try:
        fut = d.submit(mats[0], pkg.ctx.RequestContext.mint(deadline_ms=-1))
        return dict(got=_outcome(fut), counts=_counts(d))
    finally:
        d.close(timeout=T)


def _shed_at_dequeue(pkg, mats):
    sel = _Gated(pkg.key)
    d = _dispatcher(pkg, sel)
    try:
        blocker = d.submit(mats[0])
        assert sel.entered.wait(T)
        doomed = d.submit(mats[1],
                          pkg.ctx.RequestContext.mint(deadline_ms=30.0))
        time.sleep(0.1)  # the deadline passes in the queue
        sel.release.set()
        got = [_outcome(blocker), _outcome(doomed)]
        return dict(got=got, counts=_counts(d),
                    selected=pkg.key(mats[1]) in sel.order)
    finally:
        sel.release.set()
        d.close(timeout=T)


def _shed_before_build(pkg, mats):
    # the deadline passes during selection: after the dequeue, before the
    # build (150 ms leaves the idle batcher ample time to dequeue)
    d = _dispatcher(pkg, _Sleepy(0.5))
    try:
        fut = d.submit(mats[0], pkg.ctx.RequestContext.mint(deadline_ms=150))
        return dict(got=_outcome(fut), counts=_counts(d))
    finally:
        d.close(timeout=T)


def _warm_hit_expired(pkg, mats):
    d = _dispatcher(pkg, _Sleepy(0.0))
    try:
        d.submit(mats[0]).result(timeout=T)
        ctx = pkg.ctx.RequestContext.mint(deadline_ms=-1.0)
        fut = d.submit(mats[0], ctx)
        return dict(got=_outcome(fut), spans=sorted(ctx.spans),
                    same_ctx=fut.ctx is ctx, counts=_counts(d))
    finally:
        d.close(timeout=T)


def _priority(pkg, mats):
    sel = _Gated(pkg.key)
    d = _dispatcher(pkg, sel)
    try:
        futs = [d.submit(mats[0])]
        assert sel.entered.wait(T)
        futs += [d.submit(mats[i], pkg.ctx.RequestContext.mint(priority=p))
                 for i, p in ((1, 0), (2, 5), (3, 2), (4, 5))]
        sel.release.set()
        got = [_outcome(f) for f in futs]
        keys = [pkg.key(m) for m in mats]
        return dict(got=got, order=[keys.index(k) for k in sel.order])
    finally:
        sel.release.set()
        d.close(timeout=T)


def _close(pkg, mats):
    sel = _Gated(pkg.key)
    d = _dispatcher(pkg, sel)
    blocker = d.submit(mats[0])
    assert sel.entered.wait(T)
    queued = [d.submit(mats[1]), d.submit(mats[2])]
    closer = threading.Thread(target=d.close, kwargs=dict(timeout=T))
    closer.start()
    # queued requests fail at once, while the batcher is still held
    got = [_outcome(f) for f in queued]
    sel.release.set()
    closer.join(T)
    assert not closer.is_alive()
    got.append(_outcome(blocker))
    try:
        d.submit(mats[3])
        after = None
    except pkg.ctx.ServingError as exc:
        after = type(exc).__name__
    d.close(timeout=T)  # idempotent
    return dict(got=got, after=after, counts=_counts(d))


def _selector_error(pkg, mats):
    # one micro-batch of all three: it dispatches when full, long before
    # the wait runs out
    d = _dispatcher(pkg, _Broken(), batch_size=3, max_wait_ms=5000.0)
    try:
        futs = [d.submit(m) for m in mats[:3]]
        return dict(got=[_outcome(f) for f in futs], counts=_counts(d))
    finally:
        d.close(timeout=T)


def _build_error(pkg, mats):
    d = _dispatcher(pkg, _Sleepy(0.0, name="no-such-ordering"))
    try:
        fut = d.submit(mats[0])
        got = _outcome(fut)
        return dict(failed=got != "no-such-ordering", counts=_counts(d))
    finally:
        d.close(timeout=T)


def _handle(pkg, mats):
    d = _dispatcher(pkg, _Sleepy(0.0), batch_size=4, max_wait_ms=2.0)
    try:
        plans = d.handle(mats[:4] + [mats[0]], timeout=T)
        s = d.stats()
        snap = d.metrics.snapshot()
        out = dict(fps=[p.fingerprint for p in plans],
                   perms=[p.perm.tolist() for p in plans],
                   keys=sorted(k for k in s if not k.startswith("stage_")),
                   requests=snap["dispatch.requests"],
                   latency=snap["dispatch.latency_s.count"],
                   quantiles=s["p99_ms"] >= s["p50_ms"] >= 0.0,
                   stages=sorted(k for k in s if k.startswith("stage_")))
        d.reset_stats()
        out["reset"] = (d.stats()["requests"],
                        d.metrics.snapshot()["dispatch.latency_s.count"])
        return out
    finally:
        d.close(timeout=T)


SCENARIOS = {f.__name__[1:]: f for f in (
    _queue_full, _expired_at_submit, _shed_at_dequeue, _shed_before_build,
    _warm_hit_expired, _priority, _close, _selector_error, _build_error,
    _handle)}

#: what each scenario must show, beyond equality with the reference
EXPECT = {
    "queue_full": lambda o: (o["rejected"] == "QueueFull"
                             and o["got"] == ["amd"] * 3
                             and o["counts"]["rejected"] == 1),
    "expired_at_submit": lambda o: (o["got"] == "DeadlineExceeded"
                                    and o["counts"]["plans_built"] == 0
                                    and o["counts"]["shed"] == 1),
    "shed_at_dequeue": lambda o: (o["got"] == ["amd", "DeadlineExceeded"]
                                  and not o["selected"]
                                  and o["counts"]["plans_built"] == 1),
    "shed_before_build": lambda o: (o["got"] == "DeadlineExceeded"
                                    and o["counts"]["plans_built"] == 0
                                    and o["counts"]["select_calls"] == 1),
    "warm_hit_expired": lambda o: (o["got"] == "amd"
                                   and o["spans"] == ["cache", "total"]
                                   and o["same_ctx"]
                                   and o["counts"]["shed"] == 0),
    "priority": lambda o: o["order"] == [0, 2, 4, 3, 1],
    "close": lambda o: (o["got"] == ["DispatcherClosed"] * 2 + ["amd"]
                        and o["after"] == "DispatcherClosed"
                        and o["counts"]["closed_rejects"] >= 3),
    "selector_error": lambda o: (o["got"] == ["RuntimeError"] * 3
                                 and o["counts"]["errors"] == 1),
    "build_error": lambda o: o["failed"] and o["counts"]["errors"] == 1,
    "handle": lambda o: o["requests"] == 5 and o["reset"] == (0, 0),
}


@pytest.fixture(scope="module")
def stub_mats():
    return list(ref_suite(**SUITE)), list(generate_suite(**SUITE))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_dispatcher_scenario_matches_reference(name, stub_mats):
    got = SCENARIOS[name](PORT, stub_mats[1])
    want = SCENARIOS[name](REF, stub_mats[0])
    assert got == want
    assert EXPECT[name](got), got


def test_dispatcher_needs_a_selector():
    with pytest.raises(ValueError, match="selector"):
        dispatch.PlanDispatcher(plan.PlanBuilder(device="cpu"))


# ---------------------------------------------------------------------------
# trained engines: the served stream, restart from disk, solve deadlines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        ref = RefEngine(RefConfig(fast_grids=True, cv=3, cache_dir=None,
                                  backend="numpy"))
    ref.train(RefDataset.load(LABELS))
    port = SolverEngine(EngineConfig(fast_grids=True, cv=3, device="cpu"))
    port.train(LabeledDataset.load(LABELS))
    assert port.fingerprint == ref.fingerprint
    return ref, port


def _stream(n=16, distinct=6):
    rng = np.random.default_rng(5)
    pop = 1.0 / (1.0 + np.arange(distinct)) ** 1.1
    return rng.choice(distinct, size=n, p=pop / pop.sum())


def _serve_serially(server, mats, stream):
    try:
        plans = [server.submit(mats[i]).result(timeout=T) for i in stream]
    finally:
        server.close(timeout=T)
    return plans, server.stats()


def test_served_stream_matches_reference(engines):
    ref, port = engines
    pool = list(ref_suite(6, seed=3, size_scale=0.25))
    ppool = list(generate_suite(6, seed=3, size_scale=0.25))
    stream = _stream()
    want, ws = _serve_serially(ref.serve(), pool, stream)
    srv = SolverEngine(EngineConfig(device="cpu"),
                       selector=port.selector).serve()
    got, gs = _serve_serially(srv, ppool, stream)
    assert [p.algorithm for p in got] == [p.algorithm for p in want]
    for g, w in zip(got, want):
        assert g.fingerprint == w.fingerprint
        np.testing.assert_array_equal(g.perm, w.perm)
    for k in ("requests", "warm_hits", "plans_built", "select_calls",
              "hits", "misses", "shed", "errors"):
        assert gs[k] == ws[k], k
    assert gs["requests"] == len(stream)
    assert gs["plans_built"] == len(set(stream.tolist()))
    assert gs["select_calls"] == gs["plans_built"]


def test_restart_serves_from_disk(engines, tmp_path):
    _, port = engines
    mats = list(generate_suite(6, seed=3, size_scale=0.25))
    cfg = EngineConfig(device="cpu", cache_dir=str(tmp_path / "pc"),
                       build_workers=2, max_wait_ms=2.0)
    first = SolverEngine(cfg, selector=port.selector)
    plans, s1 = _serve_serially(first.serve(), mats, range(len(mats)))
    assert s1["plans_built"] == len(mats) and s1["disk_writes"] == len(mats)
    bundle = first.save(str(tmp_path / "sel.bundle"))
    again = SolverEngine.load(bundle, cfg)
    assert again.cache_version == first.cache_version
    got, s2 = _serve_serially(again.serve(), mats, range(len(mats)))
    assert s2["plans_built"] == 0 and s2["select_calls"] == 0
    assert s2["disk_hits"] == len(mats) and s2["warm_hits"] == len(mats)
    for g, p in zip(got, plans):
        np.testing.assert_array_equal(g.perm, p.perm)
    snap = again.metrics.snapshot()
    assert snap["cache.disk_hits"] == len(mats)
    assert again.stats()["disk_entries"] == len(mats)


def test_serve_in_process_and_config_fields(engines, tmp_path):
    _, port = engines
    mats = list(generate_suite(4, seed=2, size_scale=0.25))
    jsonl = str(tmp_path / "events.jsonl")
    eng = SolverEngine(EngineConfig(device="cpu", max_queue=32,
                                    default_deadline_ms=60_000.0,
                                    metrics_jsonl=jsonl, build_workers=3,
                                    max_wait_ms=1.0),
                       selector=port.selector)
    srv = eng.serve(batch_size=2)
    try:
        assert (srv.max_queue, srv.batch_size, len(srv._builders)) == \
            (32, 2, 3)
        fut = srv.submit(mats[0])
        assert fut.ctx.deadline_s is not None
        plans = srv.handle(mats, timeout=T)
        assert [p.algorithm for p in plans] == eng.select_batch(mats)
        shed = srv.submit(mats[1], reqctx.RequestContext.mint(
            deadline_ms=-1.0))  # warm: served despite the deadline
        assert shed.result(timeout=T).fingerprint == plans[1].fingerprint
        shed = srv.submit(grid2d(5, 5, "g5"),
                          reqctx.RequestContext.mint(deadline_ms=-1.0))
        with pytest.raises(reqctx.DeadlineExceeded):
            shed.result(timeout=T)
    finally:
        srv.close(timeout=T)
    eng.metrics.close()
    with open(jsonl) as f:
        assert '"event": "dispatch.shed"' in f.read()
    snap = eng.metrics.snapshot()
    assert snap["dispatch.shed"] == 1 and snap["infer.batches"] >= 1
    assert snap["mesh.shards"] == 1 and snap["mesh.shard0.requests"] == 4


def test_failed_rpc_bind_closes_the_pipeline(engines):
    _, port = engines
    eng = SolverEngine(EngineConfig(device="cpu"), selector=port.selector)
    with socket.create_server(("127.0.0.1", 0)) as busy:
        before = {t.name for t in threading.enumerate()}
        with pytest.raises(OSError):
            eng.serve(rpc=True, port=busy.getsockname()[1])
    deadline = time.monotonic() + T
    while time.monotonic() < deadline:
        alive = {t.name for t in threading.enumerate() if t.is_alive()}
        if not any(n.startswith("plan-") for n in alive - before):
            break
        time.sleep(0.05)
    assert not any(n.startswith("plan-") for n in alive - before)


def test_engine_solve_with_context_spans_and_metrics(engines):
    _, port = engines
    eng = SolverEngine(EngineConfig(device="cpu"), selector=port.selector)
    a = list(generate_suite(3, seed=4, size_scale=0.25))[1]
    b = np.random.default_rng(0).standard_normal(a.n)
    ctx = reqctx.RequestContext.mint(deadline_ms=60_000.0, request_id="s1")
    r = eng.solve(a, b, ctx=ctx)
    assert r["residual"] <= 1e-10 and r["request_id"] == "s1"
    assert {"cache", "select", "reorder", "symbolic", "permute", "factor",
            "factor.assemble", "factor.device", "solve", "solve.sweep",
            "solve.refine"} <= set(ctx.spans)
    snap = eng.metrics.snapshot()
    assert snap["solve.requests"] == 1 and snap["solve.sweep.device"] == 1
    assert snap["stage.factor.count"] == 1
    assert eng.solve(a, b)["request_id"].startswith("req-")
    with pytest.raises(reqctx.DeadlineExceeded, match="factorization start"):
        eng.solve(a, b, ctx=reqctx.RequestContext.mint(deadline_ms=-1.0))


class _ExpiresAfter:
    """A context whose deadline passes after ``n`` checks."""

    def __init__(self, n):
        self.n = n

    def expired(self):
        self.n -= 1
        return self.n < 0

    def remaining(self):
        return -0.001


@pytest.mark.parametrize("backend", ["batched", "pipelined"])
def test_factorization_stops_at_an_expired_deadline(backend):
    a = grid2d(12, 12, "g12")
    ref_err = ref_reqctx.DeadlineExceeded
    with pytest.raises(reqctx.DeadlineExceeded, match="factorization start"):
        mf.multifrontal_cholesky(a, backend=backend, device="cpu",
                                 ctx=reqctx.RequestContext.mint(
                                     deadline_ms=-1.0))
    with pytest.raises(ref_err, match="factorization start"):
        ref_mf.multifrontal_cholesky(ref_grid2d(12, 12, "g12"),
                                     backend=backend, dtype=np.float32,
                                     ctx=ref_reqctx.RequestContext.mint(
                                         deadline_ms=-1.0))
    stage = "batched level 2/" if backend == "batched" else \
        "pipelined dispatch level 2/"
    with pytest.raises(reqctx.DeadlineExceeded, match=stage):
        mf.multifrontal_cholesky(a, backend=backend, device="cpu",
                                 ctx=_ExpiresAfter(3))
    with pytest.raises(ref_err, match=stage):
        ref_mf.multifrontal_cholesky(ref_grid2d(12, 12, "g12"),
                                     backend=backend, dtype=np.float32,
                                     ctx=_ExpiresAfter(3))
    f = mf.multifrontal_cholesky(a, backend=backend, device="cpu",
                                 ctx=reqctx.RequestContext.mint(
                                     deadline_ms=60_000.0))
    assert f.stats["backend"] == backend


def test_serve_selector_launcher_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import serve_selector

    serve_selector.main(["--requests", "24", "--distinct", "6", "--batch",
                         "4", "--device", "cpu", "--cache-dir",
                         str(tmp_path / "pc")])
    out = capsys.readouterr().out
    assert "24 requests in" in out and "plans/sec end-to-end" in out
    assert "cache:" in out and " entries" in out  # the disk tier's report
    assert any(n.endswith(".torchplan.pkl")
               for n in os.listdir(tmp_path / "pc"))


def test_serving_mesh_is_one_device_and_reports_like_the_reference():
    import torch as _torch

    from repro.core.metrics import MetricsRegistry as RefRegistry
    from repro.distributed import meshctx as ref_meshctx

    from repro_torch.core.metrics import MetricsRegistry
    from repro_torch.distributed import meshctx

    cpu = meshctx.make_serving_mesh(1, "cpu")
    assert cpu.num_devices == 1 and cpu.devices == (_torch.device("cpu"),)
    with pytest.raises(ValueError, match="serving mesh wants 2"):
        meshctx.make_serving_mesh(2, "cpu")
    two = meshctx.ServingMesh((_torch.device("cpu"),) * 2)
    assert two.shard_utilization(3, 8) == [(3, 1), (0, 4)]
    with pytest.raises(ValueError, match="does not divide"):
        two.shard_utilization(3, 7)
    got, want = MetricsRegistry(), RefRegistry()
    for real, batch in ((3, 8), (8, 8), (1, 16)):
        meshctx.record_shard_utilization(got, cpu, real, batch)
        ref_meshctx.record_shard_utilization(
            want, ref_meshctx.make_serving_mesh(1), real, batch)
    assert got.snapshot() == want.snapshot()
    assert meshctx.get_serving_mesh("cpu") is meshctx.get_serving_mesh("cpu")
    try:
        eng = SolverEngine(EngineConfig(device="cpu", serving_devices=1))
        eng._ensure_serving_mesh()  # 1 is the degenerate mesh: a no-op
        assert meshctx.get_serving_mesh("cpu").num_devices == 1
        meshctx.set_serving_mesh(two)
        eng._ensure_serving_mesh()  # replaces a mesh of another width
        assert meshctx.get_serving_mesh("cpu") == cpu
    finally:
        meshctx.set_serving_mesh(None)
