"""The port's bundle lifecycle (``repro_torch.lifecycle``: campaign,
shadow, promotion gate, registry) and the engine's ``start_shadow`` /
``promote`` / ``rollback``, mirroring ``tests/test_lifecycle.py`` on the CPU
and held against the reference (``repro.lifecycle``) on the same inputs.

Selectors are trained by the reference (``test_engine.make_engine``) and
carried across as bundles through ``convert.selector_bundle_arrays``, so
both packages serve the same fitted state under the same fingerprint.
Compared: the registry index after the same sequence (apart from
timestamps and paths), gate decisions, shadow agreement and win counts over
the same mirrored stream, the campaign's cells, features (1e-6 relative),
``fill`` and ``sym_flops`` (timed labels are measurements, not compared),
kill-and-resume counts, the cache-version swaps of promote and rollback,
and ``describe()``. The port runs on the CPU (``device="cpu"``, the host
selection path); every blocking call has a timeout."""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.lifecycle import BundleRegistry as RefRegistry  # noqa: E402
from repro.lifecycle import CampaignConfig as RefCampaignConfig  # noqa: E402
from repro.lifecycle import GateRejected as RefGateRejected  # noqa: E402
from repro.lifecycle import NotPromotable as RefNotPromotable  # noqa: E402
from repro.lifecycle import PromotionGate as RefGate  # noqa: E402
from repro.lifecycle import ShadowEvaluator as RefShadow  # noqa: E402
from repro.lifecycle import evaluate_gate as ref_evaluate_gate  # noqa: E402
from repro.lifecycle import run_campaign as ref_run_campaign  # noqa: E402
from repro.sparse.dataset import generate_suite as ref_suite  # noqa: E402

from repro_torch.convert import (bundle_from_arrays,  # noqa: E402
                                 selector_bundle_arrays)
from repro_torch.engine import (EngineConfig, EngineError,  # noqa: E402
                                SelectorBundle, SolverEngine)
from repro_torch.lifecycle import (BundleRegistry,  # noqa: E402
                                   BundleRegistryError, CampaignConfig,
                                   GateRejected, NotPromotable,
                                   PromotionGate, ShadowEvaluator,
                                   assemble_dataset, evaluate_gate,
                                   run_campaign)
from repro_torch.lifecycle.registry import DEFAULT_BUNDLE_DIR  # noqa: E402
from repro_torch.sparse import csr  # noqa: E402
from repro_torch.sparse.dataset import generate_suite  # noqa: E402
from repro_torch.sparse.reorder import LABEL_ALGORITHMS  # noqa: E402

from test_engine import make_engine  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: registry fields that are wall-clock times or file paths
VOLATILE = ("registered_unix", "promoted_unix", "created_unix", "path")


def _port(a):
    return csr.CSRMatrix(a.indptr, a.indices, a.data, a.shape, a.name,
                         a.group)


def to_port(bundle) -> SelectorBundle:
    """The reference's bundle as the port's (same fields, fingerprint)."""
    return bundle_from_arrays(**selector_bundle_arrays(bundle))


def port_engine(tmp_path, ref_engine, **cfg) -> SolverEngine:
    """A port engine serving ``ref_engine``'s fitted state (and report
    card), loaded from the converted bundle, on the host selection path."""
    b = to_port(ref_engine._current_bundle())
    os.makedirs(tmp_path, exist_ok=True)
    path = b.save(str(tmp_path / f"{b.fingerprint[:12]}.bundle"))
    cfg.setdefault("cache_dir", str(tmp_path / "plan_cache"))
    return SolverEngine.load(path, EngineConfig(
        path="host", fast_grids=True, cv=3, device="cpu", **cfg))


def saved_candidate(tmp_path, seed=9):
    """(reference engine, port bundle path) of a candidate selector."""
    ref = make_engine(tmp_path / f"refcand{seed}", seed=seed)
    path = str(tmp_path / f"cand{seed}.bundle")
    to_port(ref._current_bundle()).save(path)
    return ref, path


@pytest.fixture(scope="module")
def suites():
    ref = list(ref_suite(count=4, seed=3, size_scale=0.2))
    return ref, list(generate_suite(count=4, seed=3, size_scale=0.2))


@pytest.fixture
def port_small(small_suite):
    return [_port(a) for a in small_suite]


def campaign_cfg(tmp_path, cls=CampaignConfig, **kw):
    kw.setdefault("campaign_id", "t")
    kw.setdefault("labels_dir", str(tmp_path / "labels"))
    kw.setdefault("workers", 2)
    return cls(**kw)


def _artifacts(root):
    return {fn: json.load(open(os.path.join(root, fn)))
            for fn in sorted(os.listdir(root))}


# ---------------------------------------------------------------------------
# campaign: cells, resume, sharding, assembly
# ---------------------------------------------------------------------------

def test_campaign_cells_match_the_reference(tmp_path, suites):
    """The same suite through both campaigns: the same artifacts, cells,
    features (1e-6 relative), fill and sym_flops; the report's layout and
    counts; the assembled dataset's static columns."""
    ref_res = ref_run_campaign(suites[0], campaign_cfg(
        tmp_path / "ref", RefCampaignConfig))
    res = run_campaign(suites[1], campaign_cfg(tmp_path / "port"))
    got = _artifacts(tmp_path / "port" / "labels" / "t")
    want = _artifacts(tmp_path / "ref" / "labels" / "t")
    assert got.keys() == want.keys() and len(got) == len(suites[1])
    for fn, rec in got.items():
        w = want[fn]
        for key in ("name", "group", "n", "nnz", "feature_set", "repeats",
                    "backend"):
            assert rec[key] == w[key], (fn, key)
        np.testing.assert_allclose(rec["features"], w["features"],
                                   rtol=1e-6, atol=1e-12)
        assert rec["cells"].keys() == w["cells"].keys()
        for alg, cell in rec["cells"].items():
            assert cell.keys() == w["cells"][alg].keys()
            for key in ("fill", "sym_flops"):
                assert cell[key] == w["cells"][alg][key], (fn, alg, key)
            assert all(cell[k] >= 0 for k in ("time", "t_order", "t_factor",
                                              "t_solve"))
    r, w = res.report, ref_res.report
    assert r.keys() == w.keys()
    for key in ("campaign_id", "shard", "workers", "backend", "repeats",
                "algorithms", "feature_set", "matrices", "matrices_complete",
                "cells_total", "cells_labeled", "cells_skipped",
                "cells_incomplete", "complete"):
        assert r[key] == w[key], key
    assert sum(r["per_algorithm_wins"].values()) == len(suites[1])
    assert r["label_time_breakdown"].keys() == w["label_time_breakdown"].keys()
    ds, rds = res.dataset, ref_res.dataset
    assert ds.names == rds.names and ds.algorithms == rds.algorithms
    np.testing.assert_allclose(ds.features, rds.features, rtol=1e-6,
                               atol=1e-12)
    for key in ("fills", "flops", "dims", "nnzs"):
        np.testing.assert_array_equal(getattr(ds, key), getattr(rds, key))
    assert (ds.labels == ds.times.argmin(axis=1)).all()


def test_campaign_killed_midway_resumes_without_relabeling(tmp_path, suites):
    counts = []
    for pkg, mats, cls, run in (
            ("ref", suites[0], RefCampaignConfig, ref_run_campaign),
            ("port", suites[1], CampaignConfig, run_campaign)):
        r1 = run(mats, campaign_cfg(tmp_path / pkg, cls, max_cells=5)).report
        camp = tmp_path / pkg / "labels" / "t"
        poisoned = 0
        for fn in os.listdir(camp):
            rec = json.loads((camp / fn).read_text())
            for cell in rec["cells"].values():
                cell["time"] = 123.456
                poisoned += 1
            (camp / fn).write_text(json.dumps(rec))
        r2 = run(mats, campaign_cfg(tmp_path / pkg, cls)).report
        survivors = sum(
            sum(1 for c in json.loads((camp / fn).read_text())[
                "cells"].values() if c["time"] == 123.456)
            for fn in os.listdir(camp))
        counts.append((r1["cells_labeled"], r1["complete"], poisoned,
                       r2["cells_skipped"], r2["cells_labeled"],
                       r2["complete"], survivors))
    assert counts[0] == counts[1]
    assert counts[1] == (5, False, 5, 5, 4 * len(LABEL_ALGORITHMS) - 5,
                         True, 5)


def test_campaign_shards_partition_and_assemble(tmp_path, suites):
    mats = suites[1]
    for i in range(2):
        r = run_campaign(mats, campaign_cfg(tmp_path, shard_index=i,
                                            shard_count=2)).report
        assert r["complete"]
        assert r["matrices"] == len([m for j, m in enumerate(mats)
                                     if j % 2 == i])
    ds = assemble_dataset(mats, campaign_cfg(tmp_path))
    assert ds.names == [a.name for a in mats]
    assert ds.times.shape == (len(mats), len(LABEL_ALGORITHMS))
    assert (ds.labels == ds.times.argmin(axis=1)).all()


def test_assemble_incomplete_campaign_raises(tmp_path, suites):
    run_campaign(suites[1], campaign_cfg(tmp_path, max_cells=3))
    with pytest.raises(RuntimeError, match="missing cells|no label"):
        assemble_dataset(suites[1], campaign_cfg(tmp_path))


def test_pipelined_campaign_labels_on_the_given_device(tmp_path, suites):
    """``backend="pipelined"`` labels through the device factor on the
    config's device (here the CPU's plain kernels): the same fills and
    flops as the host labels, and every cell measured."""
    mats = suites[1][:2]
    host = run_campaign(mats, campaign_cfg(tmp_path / "h", workers=1))
    dev = run_campaign(mats, campaign_cfg(tmp_path / "d", backend="pipelined",
                                          device="cpu", workers=2))
    assert dev.report["backend"] == "pipelined" and dev.report["complete"]
    np.testing.assert_array_equal(dev.dataset.fills, host.dataset.fills)
    np.testing.assert_array_equal(dev.dataset.flops, host.dataset.flops)
    assert (dev.dataset.times > 0).all()


def test_assembled_dataset_trains_an_engine(tmp_path):
    mats = list(generate_suite(count=8, seed=3, size_scale=0.2))
    res = run_campaign(mats, campaign_cfg(tmp_path))
    engine = SolverEngine(EngineConfig(
        model="decision_tree", path="host", fast_grids=True, cv=2,
        test_size=0.5, device="cpu"))
    report = engine.train(res.dataset)
    assert engine.is_trained and "test_accuracy" in report
    name, _ = engine.select(mats[0])
    assert name in LABEL_ALGORITHMS


def test_campaign_cli_fans_out_and_resumes(tmp_path):
    """``python -m repro_torch.lifecycle.campaign --processes 2``: two shard
    processes label, the parent assembles; a second run resumes every cell
    and passes the resume gate."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    base = [sys.executable, "-m", "repro_torch.lifecycle.campaign",
            "--count", "3", "--scale", "0.2", "--seed", "3",
            "--labels-dir", str(tmp_path / "labels"), "--device", "cpu",
            "--workers", "1", "--out", str(tmp_path / "report.json")]
    first = subprocess.run(base + ["--processes", "2", "--dataset-out",
                                   str(tmp_path / "ds.npz")],
                           env=env, capture_output=True, text=True,
                           timeout=300, cwd=str(tmp_path))
    assert first.returncode == 0, first.stderr[-2000:]
    assert os.path.exists(tmp_path / "ds.npz")
    again = subprocess.run(base + ["--gate-resume"], env=env,
                           capture_output=True, text=True, timeout=300,
                           cwd=str(tmp_path))
    assert again.returncode == 0, again.stderr[-2000:]
    rep = json.load(open(tmp_path / "report.json"))
    assert rep["cells_skipped"] == 3 * len(LABEL_ALGORITHMS)
    assert rep["cells_labeled"] == 0 and rep["complete"]
    assert "resume gate" in again.stdout and "OK" in again.stdout


# ---------------------------------------------------------------------------
# shadow serving
# ---------------------------------------------------------------------------

SHADOW_KEYS = ("requests", "evaluated", "agreements", "disagreements",
               "wins", "losses", "dropped", "errors")


def test_shadow_scores_like_the_reference(tmp_path, small_suite,
                                          port_small):
    """The same incumbent, candidate and mirrored stream: the same
    scorecard, and the client's plans untouched."""
    ref = make_engine(tmp_path / "ref", bundle_dir=str(tmp_path / "rb"))
    cand, cand_path = saved_candidate(tmp_path)
    engine = port_engine(tmp_path / "port", ref,
                         bundle_dir=str(tmp_path / "pb"))
    assert engine.fingerprint == ref.fingerprint

    baseline = [engine.plan(a).algorithm for a in port_small]
    assert baseline == [ref.plan(a).algorithm for a in small_suite]
    built0 = engine.builder.plans_built
    engine.start_shadow(cand_path)
    ref_cand = str(tmp_path / "refcand.bundle")
    cand.save(ref_cand)
    ref.start_shadow(ref_cand)
    shadowed = [engine.plan(a).algorithm for a in port_small]
    for a in small_suite:
        ref.plan(a)
    assert shadowed == baseline
    assert engine.builder.plans_built == built0  # all warm, no rebuilds
    assert engine.shadow.drain(60) and ref.shadow.drain(60)
    st, want = engine.shadow.stats(), ref.shadow.stats()
    assert {k: st[k] for k in SHADOW_KEYS} == {k: want[k]
                                               for k in SHADOW_KEYS}
    assert st["candidate_fingerprint"] == want["candidate_fingerprint"]
    assert st["evaluated"] == len(port_small) and st["errors"] == 0
    assert st["agreements"] + st["disagreements"] == st["evaluated"]
    assert st["wins"] + st["losses"] == st["evaluated"]
    assert st["win_rate"] == want["win_rate"]
    snap = engine.metrics.snapshot()
    assert snap["shadow.evaluated"] == len(port_small)
    assert 0.0 <= snap["shadow.win_rate"] <= 1.0
    assert snap["shadow.eval_s.count"] == len(port_small)
    final = engine.stop_shadow(timeout=30)
    assert final["evaluated"] == len(port_small) and engine.shadow is None
    ref.stop_shadow()


def test_shadow_evaluator_matches_the_reference_on_a_stream(tmp_path,
                                                            small_suite,
                                                            port_small):
    """Each structure mirrored under every label, twice (the second pass
    hits the predicted-flops memo): the same counts in both packages."""
    cand = make_engine(tmp_path, seed=9)
    ref_b = cand._current_bundle()
    ev, rev = ShadowEvaluator(to_port(ref_b)), RefShadow(ref_b)
    try:
        for _ in range(2):
            for a, pa in zip(small_suite, port_small):
                for alg in LABEL_ALGORITHMS:
                    ev.observe(pa, alg)
                    rev.observe(a, alg)
        assert ev.drain(120) and rev.drain(120)
        st, want = ev.stats(), rev.stats()
        assert {k: st[k] for k in SHADOW_KEYS} == {k: want[k]
                                                   for k in SHADOW_KEYS}
        assert st["evaluated"] == 2 * len(port_small) * len(LABEL_ALGORITHMS)
        assert len(ev._flops_cache) == len(rev._flops_cache)
    finally:
        ev.close()
        rev.close()


def test_dispatcher_mirrors_warm_and_cold_decisions(tmp_path, port_small):
    engine = port_engine(tmp_path, make_engine(tmp_path / "ref"))
    cand = make_engine(tmp_path / "cand", seed=9)
    engine.start_shadow(to_port(cand._current_bundle()))
    server = engine.serve(batch_size=2, max_wait_ms=1.0)
    try:
        cold = [f.result(60) for f in [server.submit(a) for a in port_small]]
        warm = [f.result(60) for f in [server.submit(a) for a in port_small]]
        assert [p.algorithm for p in cold] == [p.algorithm for p in warm]
        assert engine.shadow.drain(60)
        st = engine.shadow.stats()
        # the cold path mirrors once per structure, the warm once per hit
        assert st["requests"] == 2 * len(port_small)
        assert st["evaluated"] == 2 * len(port_small) and st["errors"] == 0
    finally:
        server.close(timeout=60)
        engine.stop_shadow(timeout=30)


def test_shadow_observe_never_raises_and_drops_when_full(tmp_path,
                                                         port_small):
    cand = make_engine(tmp_path, seed=9)
    ev = ShadowEvaluator(to_port(cand._current_bundle()), max_queue=1)
    try:
        ev.close()  # worker gone: observations can only queue up / drop
        for _ in range(5):
            ev.observe(port_small[0], "amd")
        st = ev.stats()
        assert st["requests"] == 5
        assert st["dropped"] >= 3  # capacity 1 (+1 possibly consumed)
    finally:
        ev.close()
    with pytest.raises(TypeError, match="candidate must be"):
        ShadowEvaluator(object())


# ---------------------------------------------------------------------------
# promotion gate + registry
# ---------------------------------------------------------------------------

def make_v1_bundle_path(tmp_path, bundle: SelectorBundle) -> str:
    """The v1-envelope recipe of the reference's tests: strip the v2
    descriptive sections."""
    path = str(tmp_path / "v1.bundle")
    bundle.save(path)
    with open(path, "rb") as f:
        env = pickle.load(f)
    env["schema_version"] = 1
    env["bundle"]["schema_version"] = 1
    del env["bundle"]["report_card"]
    del env["bundle"]["provenance"]
    with open(path, "wb") as f:
        pickle.dump(env, f)
    return path


def test_v1_bundle_loads_but_is_never_auto_promotable(tmp_path):
    engine = port_engine(tmp_path / "e", make_engine(tmp_path / "r"),
                         bundle_dir=str(tmp_path / "bundles"))
    cand = make_engine(tmp_path / "c", seed=9)
    v1_path = make_v1_bundle_path(tmp_path, to_port(cand._current_bundle()))
    b = SelectorBundle.load(v1_path)
    assert b.schema_version == 1 and b.report_card is None
    assert SolverEngine.load(v1_path, EngineConfig(device="cpu")).is_trained
    gate = PromotionGate(min_test_accuracy=0.0, require_shadow=False)
    with pytest.raises(NotPromotable, match="report card"):
        evaluate_gate(b, gate)
    with pytest.raises(RefNotPromotable):
        from repro.engine import SelectorBundle as RefBundle
        ref_evaluate_gate(RefBundle.load(v1_path), RefGate(
            min_test_accuracy=0.0, require_shadow=False))
    with pytest.raises(NotPromotable):
        engine.promote(v1_path, gate=gate)
    assert len(engine.registry) == 0  # nothing registered, nothing swapped


GATES = [(0.5, 10, 0.5, True), (0.9, 10, 0.5, True), (0.5, 100, 0.5, True),
         (0.5, 10, 0.9, True), (0.5, 10, 0.5, False), (0.95, 10, 0.9, False)]
STATS = [dict(evaluated=20, win_rate=0.75), dict(evaluated=20, win_rate=None),
         None]


@pytest.mark.parametrize("stats", STATS, ids=["ok", "no-rate", "none"])
@pytest.mark.parametrize("gate", GATES,
                         ids=lambda g: "-".join(map(str, g)))
def test_gate_decisions_match_the_reference(tmp_path, gate, stats):
    cand = make_engine(tmp_path, seed=9)
    from repro.engine import SelectorBundle as RefBundle
    ref_b = RefBundle.from_selector(cand.selector,
                                    report_card=dict(test_accuracy=0.8))
    b = to_port(ref_b)
    outcome = []
    for fn, g, bundle, rejected in (
            (evaluate_gate, PromotionGate(*gate), b, GateRejected),
            (ref_evaluate_gate, RefGate(*gate), ref_b, RefGateRejected)):
        try:
            outcome.append(("passed", fn(bundle, g, stats)))
        except rejected as e:
            outcome.append(("rejected", e.decision, str(e)))
    assert outcome[0] == outcome[1]
    assert outcome[0][1]["fingerprint"] == b.fingerprint == ref_b.fingerprint


def _index(root):
    idx = json.load(open(os.path.join(root, "registry.json")))
    for e in idx["entries"]:
        for key in VOLATILE:
            e.pop(key)
    return idx


def test_registry_sequence_matches_the_reference(tmp_path):
    """register / dedup / mark_serving / register / mark_serving / rollback
    / rollback in both registries: the same index apart from timestamps and
    paths, the same returned entries and lineage."""
    refs = [make_engine(tmp_path / "a")._current_bundle(),
            make_engine(tmp_path / "b", seed=9)._current_bundle()]
    ports = [to_port(b) for b in refs]
    trail = []
    for pkg, reg, (b1, b2) in (
            ("ref", RefRegistry(str(tmp_path / "ref")), refs),
            ("port", BundleRegistry(str(tmp_path / "port")), ports)):
        steps = [reg.register(b1, source="train"),
                 reg.register(b1),  # content dedup
                 reg.mark_serving(f"v0001-{b1.fingerprint[:12]}"),
                 reg.register(b2, source="retrain", notes="seed 9"),
                 reg.mark_serving(f"v0002-{b2.fingerprint[:12]}"),
                 reg.rollback(), reg.rollback()]
        steps = [{k: v for k, v in e.items() if k not in VOLATILE}
                 for e in steps]
        lineage = [e["version"] for e in reg.lineage()]
        trail.append((steps, lineage, reg.serving_version(),
                      reg.previous_version(), len(reg),
                      _index(str(tmp_path / pkg))))
    assert trail[0] == trail[1]
    steps, lineage, serving, previous, n, _ = trail[1]
    assert n == 2 and steps[0]["status"] == "candidate"
    assert steps[1]["version"] == steps[0]["version"]
    assert steps[3]["parent"] == steps[0]["version"]
    assert lineage == [serving, previous][:len(lineage)]
    reg = BundleRegistry(str(tmp_path / "port"))
    assert reg.load(steps[3]["version"]).fingerprint == ports[1].fingerprint
    with pytest.raises(BundleRegistryError):
        reg.entry("v9999-nope")
    assert DEFAULT_BUNDLE_DIR == os.path.join("artifacts", "bundles_torch")


def test_rollback_with_no_previous_raises(tmp_path):
    with pytest.raises(BundleRegistryError, match="roll back"):
        BundleRegistry(str(tmp_path / "bundles")).rollback()


def test_describe_matches_the_reference(tmp_path):
    eng = make_engine(tmp_path, seed=9)
    for ref_b in (eng._current_bundle(),
                  eng._current_bundle().__class__.from_selector(
                      eng.selector)):
        assert to_port(ref_b).describe() == ref_b.describe()
    d = to_port(eng._current_bundle()).describe()
    assert d["test_accuracy"] == eng.last_report["test_accuracy"]
    assert d["n_samples"] == 40 and "model_state" not in d


# ---------------------------------------------------------------------------
# promote / rollback through the engine
# ---------------------------------------------------------------------------

def _promote_rollback(engine, a_plan, suite, cand_path, cand_fp):
    """The reference test's sequence; returns what to compare."""
    fp0, cv0 = engine.fingerprint, engine.cache_version
    for a in suite:                 # warm the incumbent's two-tier cache
        engine.plan(a)
    engine.start_shadow(cand_path)
    for a in suite:
        engine.plan(a)
    assert engine.shadow.drain(60)
    shadow = {k: engine.shadow.stats()[k] for k in SHADOW_KEYS}
    name = type(engine).__module__.split(".")[0]
    rejected = GateRejected if name == "repro_torch" else RefGateRejected
    gate = PromotionGate if name == "repro_torch" else RefGate
    with pytest.raises(rejected):   # a gate the candidate cannot clear
        engine.promote(gate=gate(0.0, 1, 1.01))
    assert engine.fingerprint == fp0
    decision = engine.promote()     # config thresholds: permissive
    assert decision["passed"] and engine.fingerprint == cand_fp
    assert engine.shadow is None and engine.config.model == "decision_tree"
    assert engine.builder.sym_builds == 0  # old plans invisible
    engine.plan(a_plan)
    assert engine.builder.sym_builds == 1
    cv1 = engine.cache_version
    reg = engine.registry
    assert reg.serving_version() == decision["version"]
    assert reg.entry(decision["version"])["parent"] == \
        decision["previous_version"]
    entry = engine.rollback()
    assert entry["version"] == decision["previous_version"]
    assert engine.fingerprint == fp0
    sb = engine.builder.sym_builds  # the incumbent's plans come back
    engine.plan(a_plan)             # from disk: no symbolic rebuild
    assert engine.builder.sym_builds == sb
    decision = {k: v for k, v in decision.items() if k != "gate"}
    return (cv0, cv1, engine.cache_version, shadow, decision,
            {k: v for k, v in entry.items() if k not in VOLATILE})


def test_promote_swaps_cache_version_and_rollback_restores(
        tmp_path, small_suite, port_small):
    thresholds = dict(promote_min_accuracy=0.0,
                      promote_min_shadow_requests=1,
                      promote_min_win_rate=0.0)
    ref = make_engine(tmp_path / "ref", bundle_dir=str(tmp_path / "rb"),
                      **thresholds)
    cand, cand_path = saved_candidate(tmp_path)
    ref_cand = str(tmp_path / "refcand.bundle")
    cand.save(ref_cand)
    port = port_engine(tmp_path / "port", ref,
                       bundle_dir=str(tmp_path / "pb"), **thresholds)
    got = _promote_rollback(port, port_small[0], port_small, cand_path,
                            cand.fingerprint)
    want = _promote_rollback(ref, small_suite[0], small_suite, ref_cand,
                             cand.fingerprint)
    assert got == want
    assert got[0] == got[2] != got[1] == f"sel-{cand.fingerprint[:16]}"


def test_promote_same_bundle_twice_preserves_report_card(tmp_path):
    """After promote #1 the engine's last_report describes the old fit;
    registering the incumbent at promote #2 reuses the adopted bundle's own
    card (fingerprint-matched), not a stale report."""
    engine = port_engine(tmp_path / "e", make_engine(tmp_path / "r"),
                         bundle_dir=str(tmp_path / "bundles"))
    c1, p1 = saved_candidate(tmp_path, seed=9)
    gate = PromotionGate(min_test_accuracy=0.0, require_shadow=False)
    d1 = engine.promote(p1, gate=gate)
    c2, p2 = saved_candidate(tmp_path, seed=11)
    d2 = engine.promote(p2, gate=gate)
    assert d2["previous_version"] == d1["version"]
    inc = engine.registry.entry(d1["version"])
    assert inc["fingerprint"] == c1.fingerprint
    assert inc["test_accuracy"] == pytest.approx(
        c1.last_report["test_accuracy"])
    assert len(engine.registry) == 3  # no phantom lineage node


def test_promote_without_candidate_or_shadow_raises(tmp_path):
    engine = port_engine(tmp_path, make_engine(tmp_path / "r"),
                         bundle_dir=str(tmp_path / "bundles"))
    with pytest.raises(EngineError, match="no candidate"):
        engine.promote()


def test_config_takes_the_lifecycle_and_tuner_fields(tmp_path):
    cfg = EngineConfig(autotune_solve=True, autotune_dir=str(tmp_path / "a"),
                       bundle_dir=str(tmp_path / "b"),
                       promote_min_accuracy=0.7,
                       promote_min_shadow_requests=3,
                       promote_min_win_rate=0.6, shadow_max_queue=8,
                       device="cpu")
    gate = PromotionGate.from_config(cfg)
    assert (gate.min_test_accuracy, gate.min_shadow_requests,
            gate.min_shadow_win_rate) == (0.7, 3, 0.6)
    d = EngineConfig()
    assert d.autotune_dir == os.path.join("artifacts", "autotune_torch")
    assert d.bundle_dir == os.path.join("artifacts", "bundles_torch")
    with pytest.raises(NotImplementedError, match="item 4"):
        EngineConfig(serving_devices=2)
    eng = SolverEngine(EngineConfig(device="cpu", shadow_max_queue=8,
                                    bundle_dir=str(tmp_path / "b")))
    cand = make_engine(tmp_path / "c", seed=9)
    ev = eng.start_shadow(to_port(cand._current_bundle()))
    try:
        assert ev._queue.maxsize == 8 and ev.metrics is eng.metrics
        assert eng.registry.root == str(tmp_path / "b")
    finally:
        assert eng.stop_shadow(timeout=30)["requests"] == 0
