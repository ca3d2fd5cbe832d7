"""The port's restricted unpickler, which reads the plan cache's disk tier
and every RPC frame, admits exact (module, name) globals only: a pickle
that names a global able to run code raises ``pickle.UnpicklingError``
before that global runs, while plan files and every kind of frame the RPC
front-end sends still load."""
import io
import os
import pickle
import socket
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import plan_cache  # noqa: E402
from repro_torch.core.plan import PlanBuilder  # noqa: E402
from repro_torch.launch.rpc import (error_frame, matrix_to_wire,  # noqa: E402
                                    recv_frame, send_frame)
from repro_torch.sparse.dataset import grid2d  # noqa: E402


class _Reduce:
    """Pickles as a call of ``fn(*args)``, by module and name."""

    def __init__(self, module, name, args):
        self.module, self.name, self.args = module, name, args

    def __reduce__(self):
        import importlib

        return getattr(importlib.import_module(self.module),
                       self.name), self.args


@pytest.mark.parametrize("module,name,make_args", [
    # numpy's test helper that exec()s a string: the gadget that ran
    # through the old prefix rule
    ("numpy.testing._private.utils", "runstring",
     lambda path: (f"open({str(path)!r}, 'w').write('ran')", {})),
    # a class of the port's own with a side effect: it opens the path
    ("repro_torch.core.metrics", "JSONLSink", lambda path: (str(path),)),
])
def test_a_global_that_runs_code_raises_before_running(tmp_path, module,
                                                       name, make_args):
    path = tmp_path / "ran.txt"
    data = pickle.dumps(_Reduce(module, name, make_args(path)),
                        protocol=pickle.HIGHEST_PROTOCOL)
    assert not path.exists()
    with pytest.raises(pickle.UnpicklingError, match="not admitted"):
        plan_cache.restricted_loads(data)
    assert not path.exists()
    # the same bytes as a frame on the wire and as a plan file
    a, b = socket.socketpair()
    try:
        a.sendall(struct.pack(">I", len(data)) + data)
        with pytest.raises(pickle.UnpicklingError, match="not admitted"):
            recv_frame(b)
    finally:
        a.close()
        b.close()
    with pytest.raises(pickle.UnpicklingError, match="not admitted"):
        plan_cache.restricted_load(io.BytesIO(data))
    assert not path.exists()
    # and the gadget does run when unpickled without the restriction
    pickle.loads(data)
    assert path.exists()


def _globals(obj) -> set:
    class Rec(pickle.Unpickler):
        def find_class(self, module, name):
            seen.add((module, name))
            return super().find_class(module, name)

    seen: set = set()
    Rec(io.BytesIO(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
        ).load()
    return seen


def test_plans_and_every_frame_kind_load_and_name_admitted_globals(
        tmp_path):
    a = grid2d(6, 6, "g6")
    plan = PlanBuilder(device="cpu").build(a, "amd")
    frames = [
        {"op": "ping"},
        {"op": "plan", "matrix": matrix_to_wire(a), "request_id": "r1",
         "deadline_ms": 50.0, "priority": 1},
        {"op": "plan_batch", "matrices": [matrix_to_wire(a)] * 2,
         "request_ids": ["a", "b"]},
        {"op": "select", "matrices": [matrix_to_wire(a)]},
        {"op": "stats"}, {"op": "metrics"}, {"op": "shutdown"},
        {"ok": True, "pong": 1.0, "uptime_s": 2.0},
        {"ok": True, "plan": plan, "request_id": "r1",
         "spans_ms": {"queue": 0.1}, "server_ms": 1.5},
        {"ok": True, "plans": [plan, None], "request_ids": ["a", "b"],
         "spans_ms": [{}, {}], "errors": {1: error_frame(
             TimeoutError("late"), op="plan_batch", request_id="b")}},
        {"ok": True, "algorithms": ["amd"]},
        {"ok": True, "stats": {"hits": 3, "hit_rate": 0.5}},
        {"ok": True, "metrics": {"counters": {"rpc.requests": 4}}},
        error_frame("malformed request (no op)"),
        {"ok": True, "x": np.float64(2.5), "y": np.float32(1.5)},
    ]
    for obj in [plan] + frames:
        assert _globals(obj) <= plan_cache.ADMITTED
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        assert pickle.dumps(plan_cache.restricted_loads(data),
                            protocol=pickle.HIGHEST_PROTOCOL) == data
    x, y = socket.socketpair()
    try:
        for f in frames:
            send_frame(x, f)
            assert pickle.dumps(recv_frame(y)) == pickle.dumps(f)
    finally:
        x.close()
        y.close()
    c = plan_cache.TwoTierPlanCache(4, str(tmp_path), version="v1")
    c.put(plan.fingerprint, plan)
    back = plan_cache.TwoTierPlanCache(4, str(tmp_path), version="v1")
    got = back.get(plan.fingerprint)
    assert got is not None and np.array_equal(got.perm, plan.perm)
    assert os.listdir(tmp_path)


def test_the_admitted_globals_are_exact_pairs():
    """No prefix rule: a neighbour of an admitted name, in numpy or in the
    port, is refused."""
    for module, name in (("numpy", "load"), ("numpy.lib.npyio", "load"),
                         ("repro_torch.core.plan", "PlanBuilder"),
                         ("repro_torch.core.plan", "execute_plan"),
                         ("builtins", "eval"), ("builtins", "getattr"),
                         ("numpy._core.numeric", "fromstring")):
        assert (module, name) not in plan_cache.ADMITTED
        with pytest.raises(pickle.UnpicklingError, match="not admitted"):
            plan_cache.RestrictedUnpickler(io.BytesIO(b"")).find_class(
                module, name)
