"""Port of ``repro/launch/rpc.py`` (:54-635): the RPC front-end of the
plan-serving plane, a length-prefixed socket protocol.

    PYTHONPATH=src python -m repro_torch.launch.rpc --port 7077   # serve
    PYTHONPATH=src python -m repro_torch.launch.rpc --smoke       # round trip
    PYTHONPATH=src python -m repro_torch.launch.rpc --smoke --device cpu

It puts a stdlib-only transport in front of the dispatch core so other
processes submit matrices over a socket and get
:class:`~repro_torch.core.plan.ExecutionPlan`\\ s back::

    client                      server
    frame{op: plan, csr}  --->  PlanRPCServer (accept/conn threads)
                                  └→ AsyncPlanServer.submit (micro-batching,
                                     featurize + classify on the card, build
                                     pool, two-tier cache)
    frame{ok, plan}       <---  future resolves

**Framing.** A 4-byte big-endian length, then a pickle payload. Requests
and responses are plain dicts; matrices travel as their CSR arrays
(:func:`matrix_to_wire`, the reference's dict), plans as pickled
``ExecutionPlan``\\ s. :func:`recv_frame` unpickles through the disk tier's
:class:`~repro_torch.core.plan_cache.RestrictedUnpickler`, which admits
only the exact globals of :data:`~repro_torch.core.plan_cache.ADMITTED`:
builtin data types, numpy arrays, dtypes and scalars, and the plan's two
classes (``ExecutionPlan``, ``SymbolicFactor``). Every frame this module
sends names nothing else.

**Trust boundary.** Payloads are still pickles: listen only where clients
are trusted (localhost or a private network), as for a shared cache
directory.

Ops: ``ping``, ``plan`` (one matrix → plan), ``plan_batch`` (many),
``select`` (names only, no plan build), ``stats``, ``metrics`` (the
registry's snapshot), ``shutdown`` (drain and stop the listener).
``plan``/``plan_batch`` carry optional ``request_id`` (``request_ids``),
``deadline_ms`` and ``priority``; the server mints a
:class:`~repro_torch.core.reqctx.RequestContext` from them, and a response
echoes the request id with its ``spans_ms``. Errors are structured frames,
``{ok: False, error, error_type, op, request_id}``; the client re-raises
:class:`~repro_torch.core.reqctx.DeadlineExceeded`,
:class:`~repro_torch.core.reqctx.QueueFull` and
:class:`~repro_torch.core.reqctx.DispatcherClosed` by name and anything
else as :class:`RPCError`. A malformed frame is answered with an error
frame before the connection is dropped.
"""
from __future__ import annotations

import argparse
import pickle
import socket
import socketserver
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core.plan_cache import restricted_loads
from ..core.reqctx import SERVING_ERRORS, RequestContext, ServingError
from ..sparse.csr import CSRMatrix

__all__ = ["PlanRPCServer", "PlanRPCClient", "RPCError", "error_frame",
           "raise_from_frame", "main"]

_LEN = struct.Struct(">I")
MAX_FRAME = 1 << 30  # 1 GiB: rejects garbage/hostile length prefixes


class RPCError(RuntimeError):
    """Server-side failure surfaced to the client (message carried over).

    ``error_type`` holds the server-side exception class name,
    ``request_id`` the request the failure belongs to (both may be None
    for protocol-level failures)."""

    def __init__(self, message: str, *, error_type: Optional[str] = None,
                 request_id: Optional[str] = None):
        super().__init__(message)
        self.error_type = error_type
        self.request_id = request_id


def error_frame(exc_or_msg, *, op: Optional[str] = None,
                request_id: Optional[str] = None) -> Dict[str, Any]:
    """Structured error response: always carries op + request id (possibly
    None) so the client can attribute the failure, and the server-side
    type name so typed serving errors survive the wire."""
    if isinstance(exc_or_msg, BaseException):
        etype = type(exc_or_msg).__name__
        msg = f"{etype}: {exc_or_msg}"
    else:
        etype = "RPCError"
        msg = str(exc_or_msg)
    return {"ok": False, "error": msg, "error_type": etype,
            "op": op, "request_id": request_id}


def raise_from_frame(resp: Dict[str, Any]) -> None:
    """Client side: re-raise a typed serving error by wire name, or an
    :class:`RPCError` carrying the structured fields."""
    etype = resp.get("error_type")
    msg = resp.get("error", "unknown server error")
    cls = SERVING_ERRORS.get(etype or "")
    if cls is not None:
        raise cls(msg)
    raise RPCError(msg, error_type=etype, request_id=resp.get("request_id"))


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame"
                                  if buf else "peer closed")
        buf.extend(chunk)
    return bytes(buf)


def send_frame(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def recv_frame(sock: socket.socket) -> Any:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > MAX_FRAME:
        raise RPCError(f"frame of {n} bytes exceeds MAX_FRAME")
    return restricted_loads(_recv_exact(sock, n))


# ---------------------------------------------------------------------------
# CSR wire format — plain arrays, no class pickling on the request path
# ---------------------------------------------------------------------------

def matrix_to_wire(m: CSRMatrix) -> Dict[str, Any]:
    return {"n": int(m.n),
            "indptr": np.asarray(m.indptr, np.int32),
            "indices": np.asarray(m.indices, np.int32),
            "data": None if m.data is None else np.asarray(m.data),
            "name": m.name}


def matrix_from_wire(d: Dict[str, Any]) -> CSRMatrix:
    n = int(d["n"])
    return CSRMatrix(np.asarray(d["indptr"], np.int32),
                     np.asarray(d["indices"], np.int32),
                     None if d.get("data") is None else np.asarray(d["data"]),
                     (n, n), name=str(d.get("name", "")))


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

class PlanRPCServer:
    """Socket front-end over an ``AsyncPlanServer`` (dispatch core).

    One accept loop, one handler thread per connection (requests on a
    connection are answered in order; concurrency comes from concurrent
    connections, which all feed the same micro-batching queue — exactly
    the fan-in the deadline batcher exists for). ``port=0`` binds an
    ephemeral port, published as ``self.port`` (the launcher prints it).

    ``own_dispatcher=True`` (the default when constructed by
    ``SolverEngine.serve(rpc=True)``) makes ``close()`` shut the dispatch
    core down too; with ``False`` the caller keeps the core for further
    in-process use.
    """

    def __init__(self, dispatcher, host: str = "127.0.0.1", port: int = 0,
                 *, own_dispatcher: bool = True, backlog: int = 128):
        self.dispatcher = dispatcher
        self.own_dispatcher = own_dispatcher
        # the RPC layer reports into the same registry as the dispatch
        # core it fronts — one snapshot covers transport + pipeline
        self.metrics = getattr(dispatcher, "metrics", None)
        self._sock = socket.create_server((host, port), backlog=backlog)
        self.host, self.port = self._sock.getsockname()[:2]
        self._closed = threading.Event()
        self._conns_lock = threading.Lock()
        self._conns: List[socket.socket] = []
        self.started_unix = time.time()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rpc-accept", daemon=True)
        self._accept_thread.start()

    # -- lifecycle -----------------------------------------------------------
    def close(self, timeout: float = 30.0) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        try:
            # shutdown wakes the accept loop's blocked accept(); a bare
            # close() does not, and the join below would wait its timeout
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._accept_thread.join(timeout)
        if self.own_dispatcher:
            self.dispatcher.close(timeout)

    def serve_forever(self, poll_s: float = 0.2) -> None:
        """Block the calling thread until ``close()`` (the CLI uses this;
        embedders just keep the object around)."""
        while not self._closed.is_set():
            time.sleep(poll_s)

    # -- loops ---------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                if self._closed.is_set():
                    break  # listener closed by close()
                # transient accept failure (EMFILE under an fd burst,
                # ECONNABORTED from a mid-handshake RST): the listener is
                # still good — back off briefly and keep accepting rather
                # than silently never answering another client
                time.sleep(0.05)
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conns_lock:
                self._conns.append(conn)
            if self.metrics is not None:
                self.metrics.counter("rpc.connections").inc()
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="rpc-conn", daemon=True).start()

    def _count_request(self) -> None:
        if self.metrics is not None:
            self.metrics.counter("rpc.requests").inc()

    def _count_error(self) -> None:
        if self.metrics is not None:
            self.metrics.counter("rpc.errors").inc()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while not self._closed.is_set():
                try:
                    req = recv_frame(conn)
                except (ConnectionError, OSError):
                    return
                except Exception as exc:
                    # non-protocol peer (port scanner, HTTP probe) or a
                    # corrupt/hostile frame: answer with a structured
                    # error frame so a real-but-buggy client learns *why*,
                    # then drop the connection — there is no frame
                    # boundary to resync to, so the stream is unusable
                    self._count_error()
                    try:
                        send_frame(conn, error_frame(
                            f"malformed frame: {type(exc).__name__}: {exc}"))
                    except (ConnectionError, OSError):
                        pass
                    return
                self._count_request()
                try:
                    resp = self._handle(req)
                except Exception as exc:  # never kill the conn on one op
                    self._count_error()
                    rid = (req.get("request_id")
                           if isinstance(req, dict) else None)
                    op = req.get("op") if isinstance(req, dict) else None
                    resp = error_frame(exc, op=op, request_id=rid)
                try:
                    send_frame(conn, resp)
                except (ConnectionError, OSError):
                    return
                if isinstance(req, dict) and req.get("op") == "shutdown":
                    # the response frame is on the wire (sendall returned)
                    # — only now is it safe to tear the listener down
                    threading.Thread(target=self.close,
                                     name="rpc-shutdown",
                                     daemon=True).start()
                    return
        finally:
            with self._conns_lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            try:
                conn.close()
            except OSError:
                pass

    # -- op handlers ---------------------------------------------------------
    @staticmethod
    def _mint_ctx(req: Dict[str, Any],
                  request_id: Optional[str] = None) -> RequestContext:
        """Context from the wire fields (all optional): ``request_id`` /
        ``deadline_ms`` / ``priority``. The deadline clock starts *here*,
        at the serving edge — network transit is the client's budget."""
        return RequestContext.mint(
            request_id=request_id or req.get("request_id"),
            deadline_ms=req.get("deadline_ms"),
            priority=int(req.get("priority", 0)))

    def _handle(self, req: Any) -> Dict[str, Any]:
        if not isinstance(req, dict) or "op" not in req:
            return error_frame("malformed request (no op)")
        op = req["op"]
        timeout = float(req.get("timeout", 120.0))
        if op == "ping":
            return {"ok": True, "pong": time.time(),
                    "uptime_s": time.time() - self.started_unix}
        if op == "plan":
            mat = matrix_from_wire(req["matrix"])
            ctx = self._mint_ctx(req)
            t0 = time.perf_counter()
            try:
                plan = self.dispatcher.submit(mat, ctx).result(
                    timeout=timeout)
            except ServingError as exc:
                self._count_error()
                return error_frame(exc, op=op, request_id=ctx.request_id)
            return {"ok": True, "plan": plan,
                    "request_id": ctx.request_id,
                    "spans_ms": ctx.spans_ms(),
                    "server_ms": (time.perf_counter() - t0) * 1e3}
        if op == "plan_batch":
            mats = [matrix_from_wire(d) for d in req["matrices"]]
            rids = req.get("request_ids") or [None] * len(mats)
            ctxs = [self._mint_ctx(req, request_id=r) for r in rids]
            futs, errors = [], {}
            for i, (m, c) in enumerate(zip(mats, ctxs)):
                try:
                    futs.append(self.dispatcher.submit(m, c))
                except ServingError as exc:
                    futs.append(None)
                    errors[i] = exc
            plans: List[Any] = []
            for i, f in enumerate(futs):
                if f is None:
                    plans.append(None)
                    continue
                try:
                    plans.append(f.result(timeout=timeout))
                except ServingError as exc:
                    plans.append(None)
                    errors[i] = exc
            if errors:
                self._count_error()
            return {"ok": True, "plans": plans,
                    "request_ids": [c.request_id for c in ctxs],
                    "spans_ms": [c.spans_ms() for c in ctxs],
                    "errors": {i: error_frame(e, op=op,
                                              request_id=ctxs[i].request_id)
                               for i, e in errors.items()}}
        if op == "select":
            mats = [matrix_from_wire(d) for d in req["matrices"]]
            names = self.dispatcher.builder.select_names(mats)
            return {"ok": True, "algorithms": names}
        if op == "stats":
            return {"ok": True, "stats": self.dispatcher.stats()}
        if op == "metrics":
            snap = (self.metrics.snapshot()
                    if self.metrics is not None else {})
            return {"ok": True, "metrics": snap}
        if op == "shutdown":
            # teardown is deferred to _serve_conn AFTER the response is
            # sent — closing here would race conn.shutdown() against our
            # own reply and the client could see ECONNRESET instead of ok
            return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class PlanRPCClient:
    """Blocking client for :class:`PlanRPCServer` (one socket, in-order).

    Usable from any process with network reach to the server — no card, no
    trained model, no cache directory needed on the client side::

        with PlanRPCClient("127.0.0.1", port) as c:
            plan = c.plan(matrix)          # ExecutionPlan, cold or warm
            names = c.select([m1, m2])     # algorithm names only
            print(c.stats()["hit_rate"])

    ``connect_retries`` retries the initial TCP connect (a just-spawned
    server may not be listening yet). Not thread-safe; use one client per
    thread (connections are cheap, and the server batches across them).
    """

    def __init__(self, host: str, port: int, *, timeout: float = 120.0,
                 connect_retries: int = 20, retry_delay_s: float = 0.25):
        self.timeout = timeout
        last: Optional[Exception] = None
        for _ in range(max(1, connect_retries)):
            try:
                self._sock = socket.create_connection((host, port),
                                                      timeout=timeout)
                break
            except OSError as exc:
                last = exc
                time.sleep(retry_delay_s)
        else:
            raise ConnectionError(
                f"could not reach plan server at {host}:{port}: {last}")
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    # -- plumbing ------------------------------------------------------------
    def _call(self, op: str, **payload) -> Dict[str, Any]:
        payload["op"] = op
        payload.setdefault("timeout", self.timeout)
        # optional request fields default to absent, not None-on-the-wire
        for k in ("deadline_ms", "request_id", "request_ids", "priority"):
            if payload.get(k) is None:
                payload.pop(k, None)
        send_frame(self._sock, payload)
        resp = recv_frame(self._sock)
        if not resp.get("ok"):
            raise_from_frame(resp)
        return resp

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "PlanRPCClient":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- ops -----------------------------------------------------------------
    def ping(self) -> Dict[str, Any]:
        return self._call("ping")

    def plan(self, mat: CSRMatrix, *, deadline_ms: Optional[float] = None,
             priority: Optional[int] = None,
             request_id: Optional[str] = None):
        """One matrix → its :class:`ExecutionPlan` (server-cached).

        ``deadline_ms``/``priority``/``request_id`` ride the wire into the
        server-side :class:`RequestContext`; a shed request raises
        :class:`~repro_torch.core.reqctx.DeadlineExceeded`, a backpressure
        rejection :class:`~repro_torch.core.reqctx.QueueFull`."""
        return self.plan_detailed(mat, deadline_ms=deadline_ms,
                                  priority=priority,
                                  request_id=request_id)["plan"]

    def plan_detailed(self, mat: CSRMatrix, *,
                      deadline_ms: Optional[float] = None,
                      priority: Optional[int] = None,
                      request_id: Optional[str] = None) -> Dict[str, Any]:
        """Full ``plan`` response: plan + ``request_id`` + per-stage
        ``spans_ms`` + ``server_ms`` (the RequestContext's telemetry)."""
        return self._call("plan", matrix=matrix_to_wire(mat),
                          deadline_ms=deadline_ms, priority=priority,
                          request_id=request_id)

    def plan_with_timing(self, mat: CSRMatrix):
        """(plan, server-side milliseconds) — the smoke test uses the
        server time to show warm ≪ cold independent of network jitter."""
        r = self._call("plan", matrix=matrix_to_wire(mat))
        return r["plan"], r["server_ms"]

    def plan_batch(self, mats: Sequence[CSRMatrix], *,
                   deadline_ms: Optional[float] = None,
                   priority: Optional[int] = None) -> List:
        """Plans for a batch. Raises the first typed serving error if any
        member was shed/rejected; ``plan_batch_detailed`` returns partial
        results instead."""
        r = self.plan_batch_detailed(mats, deadline_ms=deadline_ms,
                                     priority=priority)
        errs = r.get("errors") or {}
        if errs:
            raise_from_frame(next(iter(errs.values())))
        return r["plans"]

    def plan_batch_detailed(self, mats: Sequence[CSRMatrix], *,
                            deadline_ms: Optional[float] = None,
                            priority: Optional[int] = None,
                            request_ids: Optional[Sequence[str]] = None
                            ) -> Dict[str, Any]:
        """Full ``plan_batch`` response: ``plans`` (None where a member
        failed), ``request_ids``, per-request ``spans_ms``, and ``errors``
        (index → structured error frame)."""
        return self._call("plan_batch",
                          matrices=[matrix_to_wire(m) for m in mats],
                          deadline_ms=deadline_ms, priority=priority,
                          request_ids=(list(request_ids)
                                       if request_ids else None))

    def select(self, mats: Sequence[CSRMatrix]) -> List[str]:
        return self._call("select",
                          matrices=[matrix_to_wire(m)
                                    for m in mats])["algorithms"]

    def stats(self) -> Dict[str, Any]:
        return self._call("stats")["stats"]

    def metrics(self) -> Dict[str, Any]:
        """Structured-metrics snapshot (counters/gauges/histograms) of the
        server's registry — transport and pipeline in one dict."""
        return self._call("metrics")["metrics"]

    def shutdown(self) -> None:
        self._call("shutdown")


# ---------------------------------------------------------------------------
# entrypoint: serve a trained engine over RPC / run the smoke round trip
# ---------------------------------------------------------------------------

def _train_tiny_engine(args):
    from ..core.labeling import load_or_build
    from ..engine import EngineConfig, SolverEngine

    engine = SolverEngine(EngineConfig(
        model=args.model, cache_dir=args.cache_dir or None,
        batch_size=args.batch, device=args.device, fast_grids=True, cv=3,
        seed=0))
    ds = load_or_build(cache_dir="artifacts", count=args.campaign_count,
                       seed=7, size_scale=args.campaign_scale, repeats=1,
                       verbose=False)
    rep = engine.train(ds)
    print(f"[rpc] model={args.model} test_acc={rep['test_accuracy']:.2f} "
          f"fingerprint={engine.fingerprint[:16]}")
    return engine


def main(argv=None) -> None:
    from ..core.plan_cache import DEFAULT_CACHE_DIR

    p = argparse.ArgumentParser()
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 binds an ephemeral port (printed)")
    p.add_argument("--bundle", default=None,
                   help="serve this SelectorBundle instead of training")
    p.add_argument("--model", default="decision_tree")
    p.add_argument("--devices", type=int, default=None,
                   help="serving-mesh device count (None or 1: one card)")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where selection and training run (default: the "
                        "card)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--cache-dir", default=DEFAULT_CACHE_DIR,
                   help="persistent plan-cache dir ('' stays in-memory)")
    p.add_argument("--campaign-count", type=int, default=12)
    p.add_argument("--campaign-scale", type=float, default=0.25)
    p.add_argument("--smoke", action="store_true",
                   help="serve, then run a cold+warm round trip from a "
                        "separate client process and exit nonzero on "
                        "failure")
    args = p.parse_args(argv)

    from ..engine import EngineConfig, SolverEngine

    if args.bundle:
        engine = SolverEngine.load(args.bundle, EngineConfig(
            cache_dir=args.cache_dir or None, serving_devices=args.devices,
            batch_size=args.batch, device=args.device))
    else:
        engine = _train_tiny_engine(args)

    server = engine.serve(rpc=True, host=args.host, port=args.port)
    print(f"[rpc] serving on {server.host}:{server.port} "
          f"(device: {args.device or 'cuda'})", flush=True)

    if args.smoke:
        try:
            rc = _smoke(server)
        finally:
            server.close()
        raise SystemExit(rc)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.close()


def _smoke(server: PlanRPCServer) -> int:
    """Cold + warm request from a *separate client process*: the child
    connects over TCP, plans the same structure twice, and asserts that the
    second is served from the cache."""
    import json
    import os
    import subprocess
    import sys

    child = (
        "import json, sys\n"
        "import numpy as np\n"
        "from repro_torch.launch.rpc import PlanRPCClient\n"
        "from repro_torch.sparse.dataset import grid2d\n"
        "port = int(sys.argv[1])\n"
        "m = grid2d(9, 9, 'smoke')\n"
        "with PlanRPCClient('127.0.0.1', port, timeout=120) as c:\n"
        "    pong = c.ping()\n"
        "    plan_cold, ms_cold = c.plan_with_timing(m)\n"
        "    plan_warm, ms_warm = c.plan_with_timing(m)\n"
        "    stats = c.stats()\n"
        "assert plan_cold.algorithm == plan_warm.algorithm\n"
        "assert np.array_equal(plan_cold.perm, plan_warm.perm)\n"
        "assert stats['warm_hits'] >= 1, stats\n"
        "print(json.dumps({'cold_ms': ms_cold, 'warm_ms': ms_warm,\n"
        "                  'algorithm': plan_cold.algorithm,\n"
        "                  'warm_hits': stats['warm_hits']}))\n"
    )
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    r = subprocess.run([sys.executable, "-c", child, str(server.port)],
                       capture_output=True, text=True, timeout=300, env=env)
    if r.returncode != 0:
        print(f"[rpc-smoke] FAIL\n{r.stdout}\n{r.stderr}")
        return 1
    out = json.loads(r.stdout.strip().splitlines()[-1])
    print(f"[rpc-smoke] OK cold {out['cold_ms']:.1f} ms → warm "
          f"{out['warm_ms']:.2f} ms ({out['algorithm']}, "
          f"{out['warm_hits']} warm hits)")
    return 0


if __name__ == "__main__":
    main()
