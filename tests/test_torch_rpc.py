"""The port's RPC front-end: framing, the wire format held against the
reference's, every op, typed errors over the wire, and clients in other
threads and another process.

The server wraps the port's real dispatch pipeline over a small engine
(a forest fitted on the seeded suite's features, selecting on the CPU),
bound to an ephemeral localhost port; the queue-full and closed cases
wrap a dispatcher whose stub selector the test holds. Frames unpickle
through the port's restricted unpickler: a frame naming any global outside
``repro_torch.*``, ``numpy.*`` and builtin data types is answered with an
error frame. Every blocking call has a timeout.
"""
import os
import pickle
import socket
import struct
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import rpc as ref_rpc  # noqa: E402
from repro.sparse.dataset import generate_suite as ref_suite  # noqa: E402

from repro_torch.core.dispatch import PlanDispatcher  # noqa: E402
from repro_torch.core.features import (FEATURE_NAMES,  # noqa: E402
                                       extract_features_batch)
from repro_torch.core.ml import RandomForestClassifier  # noqa: E402
from repro_torch.core.plan import PlanBuilder  # noqa: E402
from repro_torch.core.plan_cache import (PlanCache,  # noqa: E402
                                         matrix_fingerprint)
from repro_torch.core.reqctx import (SERVING_ERRORS,  # noqa: E402
                                     DeadlineExceeded, DispatcherClosed,
                                     QueueFull)
from repro_torch.core.scaling import SCALERS  # noqa: E402
from repro_torch.core.selector import ReorderSelector  # noqa: E402
from repro_torch.engine import EngineConfig, SolverEngine  # noqa: E402
from repro_torch.launch.rpc import (PlanRPCClient, PlanRPCServer,  # noqa: E402
                                    RPCError, error_frame, matrix_from_wire,
                                    matrix_to_wire, raise_from_frame,
                                    recv_frame, send_frame)
from repro_torch.sparse.dataset import generate_suite, grid2d  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
SUITE = dict(count=8, seed=3, size_scale=0.25)
T = 60  # seconds: the bound of every blocking call


@pytest.fixture(scope="module")
def mats():
    return list(generate_suite(**SUITE))


@pytest.fixture(scope="module")
def engine(mats):
    feats = extract_features_batch(mats)
    labels = (feats[:, FEATURE_NAMES.index("bandwidth")]
              / np.maximum(feats[:, 0], 1) > 0.5).astype(int)
    scaler = SCALERS["standard"]().fit(feats)
    rf = RandomForestClassifier(n_estimators=8).fit(
        scaler.transform(feats), labels)
    sel = ReorderSelector(rf, scaler, ["amd", "rcm"])
    return SolverEngine(EngineConfig(batch_size=4, max_wait_ms=2.0,
                                     device="cpu"), selector=sel)


@pytest.fixture()
def server(engine):
    srv = engine.serve(rpc=True, port=0)
    yield srv
    srv.close(timeout=T)


def _client(srv, **kw):
    kw.setdefault("timeout", T)
    return PlanRPCClient(srv.host, srv.port, **kw)


# ---------------------------------------------------------------------------
# framing and the wire format
# ---------------------------------------------------------------------------

def test_frame_round_trip_and_restricted_unpickling():
    a, b = socket.socketpair()
    a.settimeout(T)
    b.settimeout(T)
    try:
        payload = {"op": "x", "arr": np.arange(7, dtype=np.int32),
                   "f": np.float64(2.5), "t": (1, "s", None)}
        send_frame(a, payload)
        got = recv_frame(b)
        assert got["op"] == "x" and got["t"] == (1, "s", None)
        np.testing.assert_array_equal(got["arr"], payload["arr"])
        body = pickle.dumps(os.getcwd)  # names posix.getcwd
        a.sendall(struct.pack(">I", len(body)) + body)
        with pytest.raises(pickle.UnpicklingError, match="not admitted"):
            recv_frame(b)
    finally:
        a.close()
        b.close()


def test_matrix_wire_equals_the_references(mats):
    for m, r in zip(mats, ref_suite(**SUITE)):
        got, want = matrix_to_wire(m), ref_rpc.matrix_to_wire(r)
        assert set(got) == set(want) and got["n"] == want["n"]
        assert got["name"] == want["name"]
        for k in ("indptr", "indices", "data"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        back = matrix_from_wire(want)
        assert back.n == m.n and back.nnz == m.nnz and back.name == m.name
        np.testing.assert_array_equal(back.indices, m.indices)
        np.testing.assert_array_equal(back.data, m.data)


def test_error_frames_equal_the_references_and_reraise_typed():
    for name, cls in SERVING_ERRORS.items():
        frame = error_frame(cls("boom"), op="plan", request_id="r1")
        assert frame == ref_rpc.error_frame(
            ref_rpc.SERVING_ERRORS[name]("boom"), op="plan",
            request_id="r1")
        with pytest.raises(cls, match="boom"):
            raise_from_frame(frame)
    with pytest.raises(RPCError) as ei:
        raise_from_frame(error_frame(ValueError("nope"), op="plan",
                                     request_id="r2"))
    assert (ei.value.error_type, ei.value.request_id) == ("ValueError", "r2")
    assert error_frame("plain") == ref_rpc.error_frame("plain")


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def test_ping_plan_select_stats_metrics(server, engine, mats):
    with _client(server) as c:
        assert c.ping()["ok"]
        plan, _ = c.plan_with_timing(mats[0])
        assert plan.algorithm in ("amd", "rcm")
        assert type(plan).__module__ == "repro_torch.core.plan"
        assert sorted(plan.perm.tolist()) == list(range(mats[0].n))
        plan2, _ = c.plan_with_timing(mats[0])
        np.testing.assert_array_equal(plan.perm, plan2.perm)
        assert c.select(mats[:4]) == engine.select_batch(mats[:4])
        s = c.stats()
        assert s["requests"] >= 2 and s["warm_hits"] >= 1
        m = c.metrics()
        assert m["rpc.requests"] >= 5 and m["dispatch.requests"] >= 2


def test_plan_batch_op(server, mats):
    with _client(server) as c:
        plans = c.plan_batch(mats)
    assert len(plans) == len(mats)
    for m, p in zip(mats, plans):
        assert sorted(p.perm.tolist()) == list(range(m.n))


def test_unknown_op_and_malformed_request(server):
    with _client(server) as c:
        with pytest.raises(RPCError, match="unknown op"):
            c._call("definitely-not-an-op")
        send_frame(c._sock, ["not", "a", "dict"])
        resp = recv_frame(c._sock)
        assert not resp["ok"] and "malformed" in resp["error"]
        assert c.ping()["ok"]  # the connection survives a bad request


def test_garbage_and_foreign_frames_get_an_error_frame(server, mats):
    foreign = pickle.dumps({"op": "ping", "x": os.getcwd})
    frames = [struct.pack(">I", (1 << 30) + 1),
              struct.pack(">I", 4) + b"\x00\x01\x02\x03",
              struct.pack(">I", len(foreign)) + foreign]
    for raw in frames:
        s = socket.create_connection((server.host, server.port), timeout=T)
        s.sendall(raw)
        try:
            resp = recv_frame(s)
        except (ConnectionError, OSError, RPCError):
            pass  # reset before the frame landed: dropped is dropped
        else:
            assert not resp["ok"] and "malformed frame" in resp["error"]
            try:
                assert s.recv(1) == b""
            except OSError:
                pass
        s.close()
    with _client(server) as c:  # still serving
        assert c.ping()["ok"]
        assert c.plan(mats[0]).algorithm in ("amd", "rcm")


def test_concurrent_client_threads_and_exact_metrics(engine):
    srv = engine.serve(rpc=True, port=0)
    try:
        srv.dispatcher.reset_stats()
        cold = list(generate_suite(count=4, seed=77, size_scale=0.25))
        # the module's engine may hold some of these structures already
        expect = sum(srv.dispatcher.cache.peek(matrix_fingerprint(m)) is None
                     for m in cold)
        errs = []

        def one():
            try:
                with _client(srv) as c:
                    for m in cold:
                        assert c.plan(m).algorithm in ("amd", "rcm")
            except Exception as exc:  # reported below
                errs.append(exc)

        ts = [threading.Thread(target=one) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(T)
        assert not any(t.is_alive() for t in ts) and not errs
        with _client(srv) as c:
            m, s = c.metrics(), c.stats()
        assert m["dispatch.requests"] == 16
        assert m["dispatch.latency_s.count"] == 16
        assert m["cache.memory_hits"] + m["cache.misses"] == 16
        assert s["plans_built"] == expect  # in-flight joins: one a key
        assert m["rpc.connections"] >= 5
    finally:
        srv.close(timeout=T)


def test_shutdown_acks_then_close_is_idempotent(engine):
    srv = engine.serve(rpc=True, port=0)
    with _client(srv) as c:
        c.shutdown()
    srv._accept_thread.join(T)
    assert srv._closed.is_set() and not srv._accept_thread.is_alive()
    srv.close(timeout=T)
    srv2 = engine.serve(rpc=True, port=0)
    c = _client(srv2, connect_retries=1)
    assert c.ping()["ok"]
    srv2.close(timeout=T)
    srv2.close(timeout=T)
    with pytest.raises((ConnectionError, OSError)):
        c.ping()
    c.close()


# ---------------------------------------------------------------------------
# request identity and typed errors over the wire
# ---------------------------------------------------------------------------

def test_request_identity_and_spans(server):
    cold = grid2d(12, 12, "wire-ident")
    with _client(server) as c:
        resp = c.plan_detailed(cold, request_id="req-wire-42",
                               deadline_ms=60_000, priority=2)
        assert resp["ok"] and resp["request_id"] == "req-wire-42"
        assert {"queue", "select", "build", "cache", "reorder", "symbolic",
                "total"} <= set(resp["spans_ms"])
        assert resp["server_ms"] > 0
        warm = c.plan_detailed(cold)
        assert warm["request_id"].startswith("req-")
        assert set(warm["spans_ms"]) == {"cache", "total"}


def test_deadline_shed_and_partial_batch(server, mats):
    cold = grid2d(13, 13, "wire-deadline")
    with _client(server) as c:
        with pytest.raises(DeadlineExceeded):
            c.plan(cold, deadline_ms=0)
        p = c.plan(cold)
        np.testing.assert_array_equal(c.plan(cold, deadline_ms=0).perm,
                                      p.perm)  # warm: served past it
        other = grid2d(14, 14, "wire-batch")
        c.plan(mats[0])
        resp = c.plan_batch_detailed([mats[0], other], deadline_ms=0)
        assert resp["plans"][0] is not None and resp["plans"][1] is None
        err = resp["errors"][1]
        assert err["error_type"] == "DeadlineExceeded"
        assert err["request_id"] == resp["request_ids"][1]
        with pytest.raises(DeadlineExceeded):
            c.plan_batch([mats[0], other], deadline_ms=0)
        assert c.stats()["shed"] >= 2


class _Gated:
    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def select_batch(self, batch, path="host", **kw):
        self.entered.set()
        self.release.wait(T)
        return ["amd"] * len(batch), 0.0

    def select(self, a):
        return "amd", 0.0


def test_queue_full_and_closed_come_back_typed(mats):
    sel = _Gated()
    d = PlanDispatcher(PlanBuilder(sel, PlanCache(16), path="host",
                                   device="cpu"),
                       batch_size=1, max_wait_ms=1.0, build_workers=1,
                       max_queue=1)
    srv = PlanRPCServer(d, port=0, own_dispatcher=False)
    got = {}

    def plan(i):
        with _client(srv) as c:
            try:
                got[i] = c.plan(mats[i]).algorithm
            except Exception as exc:
                got[i] = type(exc).__name__

    held = threading.Thread(target=plan, args=(0,))
    try:
        held.start()
        assert sel.entered.wait(T)
        queued = threading.Thread(target=plan, args=(1,))
        queued.start()
        with _client(srv) as c:
            end = time.monotonic() + T
            while c.stats()["queue_depth"] < 1 and time.monotonic() < end:
                time.sleep(0.005)
            with pytest.raises(QueueFull):
                c.plan(mats[2])
            assert c.stats()["rejected"] == 1
        sel.release.set()
        held.join(T)
        queued.join(T)
        assert got == {0: "amd", 1: "amd"}
        d.close(timeout=T)  # the server stays up; its dispatcher is closed
        with _client(srv) as c:
            with pytest.raises(DispatcherClosed):
                c.plan(mats[3])
            assert c.ping()["ok"]
    finally:
        sel.release.set()
        srv.close(timeout=T)
        d.close(timeout=T)
    assert not held.is_alive()


# ---------------------------------------------------------------------------
# other processes: a client process, and the launcher's smoke
# ---------------------------------------------------------------------------

def test_cold_and_warm_from_a_separate_process(server):
    child = textwrap.dedent("""
        import sys
        import numpy as np
        from repro_torch.launch.rpc import PlanRPCClient
        from repro_torch.sparse.dataset import grid2d
        m = grid2d(8, 8, "rpc-proc")
        with PlanRPCClient("127.0.0.1", int(sys.argv[1]), timeout=60) as c:
            cold, _ = c.plan_with_timing(m)
            warm, _ = c.plan_with_timing(m)
            stats = c.stats()
        assert cold.algorithm == warm.algorithm
        assert np.array_equal(cold.perm, warm.perm)
        assert stats["warm_hits"] >= 1, stats
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "repro"))
        assert not bad, bad
        print("PROC-RPC-OK", cold.algorithm)
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", child, str(server.port)],
                       capture_output=True, text=True, timeout=180, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    assert "PROC-RPC-OK" in r.stdout


def test_rpc_smoke_launcher_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.rpc",
                        "--smoke", "--device", "cpu", "--cache-dir",
                        str(tmp_path / "pc")],
                       capture_output=True, text=True, timeout=240, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    assert "[rpc-smoke] OK" in r.stdout
    assert any(n.endswith(".torchplan.pkl")
               for n in os.listdir(tmp_path / "pc"))
