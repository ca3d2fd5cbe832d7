"""The port's engine against the reference's, trained alike on the same
label set (``artifacts/labels_c36_s7_x0.35_r1.npz``, ``fast_grids=True``,
``cv=3``, in-memory plan cache) and served the same seeded suite: equal
fingerprints, identical selected names and plans, and solutions within
1e-8 relative of the reference's host fp64 solve with residuals ≤ 1e-10.
The port runs on the CPU (``device="cpu"``: the kernels' plain versions);
the reference selects through its Pallas kernels in interpret mode. Also:
the plan cache, the config's refusals and the serving fields it takes,
bundles through the engine, the default device, and selection from two
threads at once.
"""
import copy
import json
import os
import socket
import sys
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.labeling import LabeledDataset as RefDataset  # noqa: E402
from repro.core.plan_cache import matrix_fingerprint as ref_key  # noqa: E402
from repro.engine import EngineConfig as RefConfig  # noqa: E402
from repro.engine import SolverEngine as RefEngine  # noqa: E402
from repro.sparse.dataset import generate_suite as ref_suite  # noqa: E402

from repro_torch.core.labeling import LabeledDataset  # noqa: E402
from repro_torch.core.plan import PlanBuilder, matrix_fingerprint  # noqa: E402
from repro_torch.core.plan_cache import (PlanCache,  # noqa: E402
                                         TwoTierPlanCache)
from repro_torch.core.selector import ReorderSelector  # noqa: E402
from repro_torch.engine import EngineConfig, EngineError, SolverEngine  # noqa: E402
from repro_torch.launch.rpc import PlanRPCClient  # noqa: E402
from repro_torch.sparse.dataset import generate_suite  # noqa: E402

LABELS = "artifacts/labels_c36_s7_x0.35_r1.npz"
SUITE = dict(count=12, seed=3, size_scale=0.25)


@pytest.fixture(scope="module")
def engines():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        ref = RefEngine(RefConfig(fast_grids=True, cv=3, cache_dir=None,
                                  backend="numpy"))
    ref.train(RefDataset.load(LABELS))
    port = SolverEngine(EngineConfig(fast_grids=True, cv=3, device="cpu"))
    port.train(LabeledDataset.load(LABELS))
    return ref, port


@pytest.fixture(scope="module")
def mats():
    return list(ref_suite(**SUITE)), list(generate_suite(**SUITE))


def test_fingerprints_equal(engines):
    ref, port = engines
    assert port.fingerprint == ref.fingerprint
    assert port.cache_version == ref.cache_version
    assert port.last_report["test_accuracy"] == \
        ref.last_report["test_accuracy"]


def test_selected_names_identical(engines, mats):
    ref, port = engines
    want, _ = ref.selector.select_batch(mats[0], path="device",
                                        use_pallas=True)
    assert port.select_batch(mats[1]) == want
    host, _ = port.selector.select_batch(mats[1], path="host")
    assert host == want
    assert [port.select(a)[0] for a in mats[1]] == \
        [ref.select(a)[0] for a in mats[0]]


def test_plans_identical_and_cached(engines, mats):
    ref, port = engines
    ref_plans = ref.plan_batch(mats[0])
    port.builder.reset_stats()
    plans = port.plan_batch(mats[1])
    for p, r in zip(plans, ref_plans):
        assert (p.fingerprint, p.algorithm) == (r.fingerprint, r.algorithm)
        np.testing.assert_array_equal(p.perm, r.perm)
        for f in ("parent", "counts", "Lp", "Li"):
            np.testing.assert_array_equal(getattr(p.sym, f),
                                          getattr(r.sym, f))
        assert p.predicted_flops == r.predicted_flops
    cold = port.stats()
    assert cold["select_calls"] == 1 and cold["sym_builds"] == len(mats[1])
    again = port.plan_batch(mats[1])
    warm = port.stats()
    assert all(a is b for a, b in zip(again, plans))
    assert warm["select_calls"] == cold["select_calls"]
    assert warm["sym_builds"] == cold["sym_builds"]
    assert warm["hits"] - cold["hits"] == len(mats[1])


def test_solve_batch_matches_reference(engines, mats):
    ref, port = engines
    rng = np.random.default_rng(0)
    bs = [rng.standard_normal(a.n) for a in mats[1]]
    want = ref.solve_batch(mats[0], bs)
    got = port.solve_batch(mats[1], bs)
    for a, b, g, w in zip(mats[1], bs, got, want):
        assert g["algorithm"] == w["algorithm"]
        assert g["refine_converged"] and g["device"] == "cpu"
        res = np.linalg.norm(a.matvec(g["x"]) - b) / np.linalg.norm(b)
        assert res <= 1e-10 and g["residual"] <= 1e-10
        err = np.abs(g["x"] - w["x"]).max() / np.abs(w["x"]).max()
        assert err <= 1e-8, (a.name, err)
        assert (g["backend"], g["sweep"], g["solve_dtype"]) == (
            "pipelined", "device", "fp32_refine")


def test_solve_one_matrix_through_the_cache(engines, mats):
    _, port = engines
    a = mats[1][4]
    b = np.random.default_rng(1).standard_normal(a.n)
    r = port.solve(a, b)
    assert r["residual"] <= 1e-10 and r["refine_converged"]
    assert port.plan(a) is port.plan(a)


def test_engine_bundles_cross_packages(engines, mats, tmp_path):
    ref, port = engines
    path = str(tmp_path / "port.bundle")
    port.save(path)
    back = SolverEngine.load(path, EngineConfig(device="cpu"))
    assert back.fingerprint == port.fingerprint
    assert back.select_batch(mats[1]) == port.select_batch(mats[1])
    assert RefEngine.load(path, RefConfig(cache_dir=None)).fingerprint == \
        port.fingerprint
    ref_path = str(tmp_path / "ref.bundle")
    ref.save(ref_path)
    from_ref = SolverEngine.load(ref_path, EngineConfig(device="cpu"))
    assert from_ref.fingerprint == ref.fingerprint
    assert from_ref.config.model == "random_forest"


def test_refit_re_versions_the_cache(engines):
    _, port = engines
    eng = SolverEngine(EngineConfig(fast_grids=True, cv=3, device="cpu"),
                       selector=port.selector)
    builder = eng.builder
    assert eng.fingerprint == port.fingerprint
    eng.train(LabeledDataset.load(LABELS), seed=1)
    assert eng.fingerprint != port.fingerprint
    assert eng.builder is not builder


def test_engine_misuse_raises():
    eng = SolverEngine(EngineConfig(device="cpu"))
    assert eng.fingerprint is None
    with pytest.raises(EngineError, match="no trained selector"):
        eng.select_batch([])
    with pytest.raises(EngineError, match="no fingerprint"):
        eng.cache_version
    with pytest.raises(EngineError, match="asserts algorithms"):
        SolverEngine(EngineConfig(algorithms=["amd", "rcm"])).train(
            LabeledDataset.load(LABELS))


@pytest.mark.parametrize("kw", [
    dict(backend="numpy"), dict(backend="pallas"), dict(backend="batched"),
    dict(sweep="seq"), dict(sweep="level"), dict(sweep="auto"),
    dict(solver="simplicial")],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_config_solves_with_every_ported_path(engines, mats, kw):
    """The values the config once refused: each now goes through
    ``solve_batch`` to the reference's residual gate."""
    _, port = engines
    eng = SolverEngine(EngineConfig(device="cpu", **kw),
                       selector=port.selector)
    a2 = mats[1][:2]
    rng = np.random.default_rng(3)
    bs = [rng.standard_normal(a.n) for a in a2]
    for a, b, r in zip(a2, bs, eng.solve_batch(a2, bs)):
        assert r["residual"] <= 1e-10, (kw, r["residual"])
        assert np.linalg.norm(a.matvec(r["x"]) - b) \
            <= 1e-10 * np.linalg.norm(b)
        assert r["backend"] == kw.get("backend", "pipelined")
        assert r["solver"] == kw.get("solver", "multifrontal")


@pytest.mark.parametrize("kw", [
    dict(serving_devices=2), dict(autotune_solve=True),
    dict(autotune_dir="at"), dict(bundle_dir="bundles"),
    dict(promote_min_accuracy=0.9), dict(shadow_max_queue=8)],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_config_refuses_what_is_not_ported(kw, engines, mats):
    """Every field once refused here is ported and taken as given; a
    serving mesh of two devices serves on a 2-wide CPU mesh, selecting
    what the one-device engine selects."""
    from repro_torch.distributed import meshctx

    cfg = EngineConfig(**kw)
    assert all(getattr(cfg, k) == v for k, v in kw.items())
    if "serving_devices" not in kw:
        return
    _, port = engines
    eng = SolverEngine(EngineConfig(device="cpu", **kw),
                       selector=port.selector)
    try:
        plans = eng.plan_batch(mats[1])
        assert meshctx.get_serving_mesh("cpu").num_devices == 2
        assert [p.algorithm for p in plans] == [
            port.plan(a).algorithm for a in mats[1]]
        assert eng.metrics.snapshot()["mesh.shards"] == 2
    finally:
        meshctx.set_serving_mesh(None)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _takes_cache_dir(eng, tmp_path, mats):
    plan = eng.plan(mats[1][0])
    cache = eng.builder.cache
    assert isinstance(cache, TwoTierPlanCache)
    assert cache.version == eng.cache_version
    assert os.path.exists(cache._path(plan.fingerprint))
    assert cache._path(plan.fingerprint).startswith(str(tmp_path))


def _takes_max_queue(eng, tmp_path, mats):
    srv = eng.serve()
    try:
        assert srv.max_queue == 8 and srv._queue.maxsize == 8
        assert srv.stats()["max_queue"] == 8
    finally:
        srv.close(timeout=60)


def _takes_metrics_jsonl(eng, tmp_path, mats):
    eng.metrics.emit("probe", n=1)
    eng.metrics.close()
    rec = json.loads(open(tmp_path / "m.jsonl").read().splitlines()[0])
    assert rec["event"] == "probe" and rec["n"] == 1


def _takes_rpc_port(eng, tmp_path, mats):
    srv = eng.serve(rpc=True)
    try:
        assert srv.port == eng.config.rpc_port
        with PlanRPCClient("127.0.0.1", srv.port, timeout=60) as c:
            assert c.ping()["ok"]
    finally:
        srv.close(timeout=60)


SERVING_FIELDS = {
    "cache_dir": (lambda tmp: str(tmp / "pc"), _takes_cache_dir),
    "max_queue": (lambda tmp: 8, _takes_max_queue),
    "metrics_jsonl": (lambda tmp: str(tmp / "m.jsonl"), _takes_metrics_jsonl),
    "rpc_port": (lambda tmp: _free_port(), _takes_rpc_port),
}


@pytest.mark.parametrize("field", sorted(SERVING_FIELDS))
def test_config_serving_field_takes_effect(field, engines, mats, tmp_path):
    """The serving fields the config once refused build an engine whose
    cache, dispatcher, metrics or RPC front-end uses them."""
    _, port = engines
    value, check = SERVING_FIELDS[field]
    eng = SolverEngine(EngineConfig(device="cpu", **{field: value(tmp_path)}),
                       selector=port.selector)
    check(eng, tmp_path, mats)


def test_two_threads_select_through_one_builder(engines, mats, monkeypatch):
    """Concurrent first selections through one PlanBuilder flatten and
    upload the forest once and agree with a serial selection."""
    from repro_torch.core.ml import forest_torch

    _, port = engines
    model = copy.deepcopy(port.selector.model)
    model.__dict__.pop("_flat", None)
    sel = ReorderSelector(model, port.selector.scaler,
                          port.selector.algorithms)
    builder = PlanBuilder(sel, batch_size=4, device="cpu")
    uploads, real = [], forest_torch._upload

    def slow_upload(fa, device):
        uploads.append(device)
        time.sleep(0.05)  # widen the window two unguarded threads race in
        return real(fa, device)

    monkeypatch.setattr(forest_torch, "_upload", slow_upload)
    go = threading.Barrier(4)
    out, errs = {}, []

    def work(i):
        try:
            go.wait(60)
            out[i] = builder.select_names(mats[1])
        except Exception as exc:  # reported below
            errs.append(exc)

    ts = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts) and not errs
    want = port.select_batch(mats[1])
    assert all(out[i] == want for i in range(4))
    assert len(uploads) == 1 and list(model._flat[2]) == [torch.device("cpu")]
    assert builder.select_calls == 4 * 3  # 12 matrices in chunks of 4


def test_launch_counts_and_kernel_build_are_thread_safe(monkeypatch,
                                                        tmp_path):
    """``count_launch`` loses no update under contention, and racing first
    calls of ``load_kernels`` build once."""
    import torch.utils.cpp_extension

    from repro_torch.kernels import _build

    def wrapper():
        pass

    wrapper.launches = 0
    builds = []

    def fake_load(**kw):
        builds.append(kw["name"])
        time.sleep(0.05)

    monkeypatch.setattr(_build, "_OPS", None)
    monkeypatch.setattr(torch.utils.cpp_extension, "load", fake_load)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            _build.load_kernels()
            for _ in range(5000):
                _build.count_launch(wrapper)
        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 40000 and len(builds) == 1
    _build.reset_launches([wrapper])
    assert wrapper.launches == 0


def test_config_defaults_are_the_served_main_path():
    cfg = EngineConfig()
    assert (cfg.path, cfg.backend, cfg.sweep, cfg.solve_dtype,
            cfg.cache_dir, cfg.device, cfg.batch_size) == (
        "device", "pipelined", "device", "fp32_refine", None, None, 16)
    assert not hasattr(cfg, "use_pallas")
    with pytest.raises(ValueError):
        EngineConfig(path="mesh")
    with pytest.raises(ValueError):
        EngineConfig(device="tpu")
    with pytest.warns(UserWarning, match="fp32_refine"):
        EngineConfig(solve_dtype="fp64")


def test_default_engine_needs_a_card(engines, mats):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    _, port = engines
    eng = SolverEngine(EngineConfig(), selector=port.selector)
    with pytest.raises(RuntimeError, match="CUDA"):
        eng.select_batch(mats[1][:2])
    with pytest.raises(RuntimeError, match="CUDA"):
        eng.solve_batch(mats[1][:2])


def test_plan_builder_selects_on_the_host_without_an_algorithm(engines, mats):
    _, port = engines
    builder = PlanBuilder(port.selector, device="cpu")
    a = mats[1][2]
    plan = builder.build(a)
    assert plan.algorithm == port.select(a)[0]
    assert set(plan.meta) == {"t_build", "t_reorder", "t_symbolic",
                              "t_select"}
    assert plan.meta["t_select"] > 0 and builder.select_calls == 1
    with pytest.raises(ValueError, match="no selector"):
        PlanBuilder().build(a)
    with pytest.raises(ValueError, match="no selector"):
        PlanBuilder().select_names([a])


def test_select_names_pads_partial_device_chunks(engines, mats):
    _, port = engines
    builder = PlanBuilder(port.selector, batch_size=5, device="cpu")
    names = builder.select_names(mats[1])
    assert names == port.select_batch(mats[1])
    assert builder.select_calls == 3  # 12 matrices in chunks of 5


def test_plan_cache_lru_and_fingerprint(mats):
    for a, b in zip(*mats):
        assert matrix_fingerprint(b) == ref_key(a)
    cache = PlanCache(capacity=2)
    cache.put("a", 1)
    cache.put("b", 2)
    assert cache.get("a") == 1          # a is now most recent
    cache.put("c", 3)                   # evicts b
    assert "b" not in cache and cache.get("b") is None
    assert "c" in cache and len(cache) == 2
    s = cache.stats()
    assert (s["hits"], s["misses"], s["evictions"]) == (1, 1, 1)
    assert s["hit_rate"] == 0.5 and s["size"] == 2
    cache.reset_stats()
    assert cache.stats()["hits"] == 0 and len(cache) == 2
