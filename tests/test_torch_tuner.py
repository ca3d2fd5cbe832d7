"""The port's solve tuner (``repro_torch.autotune.solve_tuner``) against the
reference's (``repro.autotune.solve_tuner``) on the CPU: the policy record
and its JSON, the staleness rules of ``load_policy`` on identical files,
``seed_order`` on the same benchmark-shaped file, ``get_policy``'s
default → tuned → cached sequence, the port's own file name (a policy the
reference wrote is a miss), a ``tune(device="cpu")`` record the reference
reads, and the engine applying a persisted policy with the reference
engine's knobs. The port runs its kernels' plain versions
(``device="cpu"``); every suite is two small matrices."""
import dataclasses
import json
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.autotune import solve_tuner as ref_st  # noqa: E402
from repro.engine import EngineConfig as RefConfig  # noqa: E402
from repro.engine import SolverEngine as RefEngine  # noqa: E402

from repro_torch.autotune import solve_tuner as st  # noqa: E402
from repro_torch.core.labeling import LabeledDataset  # noqa: E402
from repro_torch.engine import EngineConfig, SolverEngine  # noqa: E402
from repro_torch.sparse.dataset import block_arrow, grid2d  # noqa: E402
from repro_torch.sparse.reorder import LABEL_ALGORITHMS  # noqa: E402

FULL = dict(bs=16, pad="mult8", device_kind="cpu", backend="pipelined",
            warm_factor_s=0.25, source="tuned", sweep_bs=16, rt=8,
            warm_sweep_s=0.125)
#: a record written before the sweep knobs existed
PRE_SWEEP = {k: v for k, v in FULL.items()
             if k not in ("sweep_bs", "rt", "warm_sweep_s")}


def _mats():
    return [grid2d(6, 6, "tune_g6"),
            block_arrow(2, 6, 3, np.random.default_rng(0), "tune_arrow")]


def _asdict(p):
    return dataclasses.asdict(p)


@pytest.mark.parametrize("fields", [FULL, PRE_SWEEP, {}],
                         ids=["full", "pre-sweep", "default"])
def test_policy_json_round_trips_like_the_reference(fields):
    port, ref = st.SolvePolicy(**fields), ref_st.SolvePolicy(**fields)
    assert port.to_json() == ref.to_json()
    doc = dict(schema=st.SCHEMA, **fields)
    assert _asdict(st.SolvePolicy.from_json(doc)) == \
        _asdict(ref_st.SolvePolicy.from_json(doc))
    back = st.SolvePolicy.from_json(json.loads(json.dumps(port.to_json())))
    assert back == port
    assert st.SCHEMA == ref_st.SCHEMA == 1


STALE = {
    "valid": lambda d: d,
    "schema": lambda d: dict(d, schema=2),
    "kind": lambda d: dict(d, device_kind="TPU v4"),
    "pad": lambda d: dict(d, pad="pow3"),
    "backend": lambda d: dict(d, backend="batched"),
    "pre-sweep": lambda d: {k: v for k, v in d.items()
                            if k not in ("sweep_bs", "rt", "warm_sweep_s")},
    "unknown-field": lambda d: dict(d, bogus=1),
    "malformed": None,
}


@pytest.mark.parametrize("case", list(STALE))
def test_load_policy_staleness_rules_match_the_reference(tmp_path, case):
    """The same bytes under each package's own file name: both load it or
    both miss."""
    doc = dict(schema=1, **FULL)
    text = ("{not json" if STALE[case] is None
            else json.dumps(STALE[case](doc)))
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    for d, path in ((port_dir, st.policy_path(str(port_dir), "cpu")),
                    (ref_dir, ref_st.policy_path(str(ref_dir), "cpu"))):
        d.mkdir()
        with open(path, "w") as fh:
            fh.write(text)
    for backend in (None, "pipelined"):
        got = st.load_policy(str(port_dir), "cpu", backend=backend)
        want = ref_st.load_policy(str(ref_dir), "cpu", backend=backend)
        assert (got is None) == (want is None), (case, backend)
        if got is not None:
            assert got.source == "cached"
            assert _asdict(got) == _asdict(want)
    assert (st.load_policy(str(port_dir), "cpu") is not None) == \
        (case in ("valid", "backend", "pre-sweep"))


@pytest.mark.parametrize("records", [
    [0.9, 0.8], [0.3, 0.4], [0.6, 0.1], [], None, "malformed"],
    ids=["high", "low", "mixed", "no-records", "missing", "malformed"])
def test_seed_order_matches_the_reference(tmp_path, records):
    path = str(tmp_path / "BENCH_solve.json")
    if records == "malformed":
        open(path, "w").write("[")
    elif records is not None:
        json.dump({"records": [dict(name=f"m{i}", occupancy=o)
                               for i, o in enumerate(records)]
                   + [dict(name="no_occupancy")]}, open(path, "w"))
    for pads in (("pow2", "mult8"), ("mult8", "pow2"), ("pow2",),
                 ("pow2", "bogus", "mult8")):
        assert st.seed_order(path, pads) == ref_st.seed_order(path, pads)
    assert st.seed_order(path) == ref_st.seed_order(path)


TINY = dict(bs_grid=(16, 64), pads=("pow2",), repeats=1,
            sweep_bs_grid=(None,), rt_grid=(None,))


def test_get_policy_default_tuned_cached(tmp_path):
    """``autotune=False`` → default (nothing written); ``autotune=True`` →
    tuned and persisted; then cached without measuring — the reference's
    sequence."""
    calls = []
    seq = []
    d = str(tmp_path / "at")
    for autotune in (False, True, True, False):
        pol = st.get_policy(d, autotune=autotune, device="cpu",
                            mats=_mats(), bench_path=str(tmp_path / "none"),
                            on_candidate=lambda *a: calls.append(a), **TINY)
        seq.append(pol.source)
        assert pol.device_kind == "cpu" and pol.backend == "pipelined"
    assert seq == ["default", "tuned", "cached", "cached"]
    assert len(calls) == 3  # two factor candidates, one sweep, measured once
    assert os.listdir(d) == ["solve_policy_torch_cpu.json"]
    forced = st.get_policy(d, force=True, autotune=True, device="cpu",
                           mats=_mats(), bench_path=str(tmp_path / "none"),
                           **TINY)
    assert forced.source == "tuned"
    # the reference's default record, field for field
    ref_default = ref_st.get_policy(str(tmp_path / "ref"))
    assert _asdict(st.get_policy(str(tmp_path / "empty"), device="cpu")) \
        == _asdict(ref_default)


def test_reference_policy_in_the_port_directory_is_a_miss(tmp_path):
    """A policy the reference measured (its ``solve_policy_cpu.json``) sits
    in the port's directory: the port neither loads nor serves it."""
    d = str(tmp_path)
    ref_path = ref_st.save_policy(ref_st.SolvePolicy(**FULL), d)
    assert os.path.basename(ref_path) == "solve_policy_cpu.json"
    assert ref_st.load_policy(d, "cpu", "pipelined") is not None
    assert st.load_policy(d, "cpu", "pipelined") is None
    pol = st.get_policy(d, device="cpu")
    assert pol.source == "default" and (pol.bs, pol.pad) == (None, "pow2")
    assert st.policy_path(d, "NVIDIA H100 80GB HBM3").endswith(
        "solve_policy_torch_nvidia-h100-80gb-hbm3.json")
    assert st.DEFAULT_AUTOTUNE_DIR == os.path.join("artifacts",
                                                   "autotune_torch")


def test_tune_on_the_cpu_writes_a_record_the_reference_reads(tmp_path):
    seen = []
    pol = st.tune(_mats(), device="cpu", out_dir=str(tmp_path),
                  bs_grid=(16, 64), pads=("pow2",), repeats=1,
                  sweep_bs_grid=(None, 16), rt_grid=(None,),
                  bench_path=str(tmp_path / "none"),
                  on_candidate=lambda *a: seen.append(a))
    assert [(s, k) for s, k, _ in seen] == [
        ("factor", ("pow2", 16)), ("factor", ("pow2", 64)),
        ("sweep", (None, None)), ("sweep", (16, None))]
    assert all(t > 0 for _, _, t in seen)
    factor = {k: t for s, k, t in seen if s == "factor"}
    assert pol.warm_factor_s == min(factor.values())
    assert (pol.pad, pol.bs) == min(factor, key=factor.get)
    assert pol.source == "tuned" and pol.device_kind == "cpu"
    doc = json.load(open(st.policy_path(str(tmp_path), "cpu")))
    ref = ref_st.SolvePolicy.from_json(doc)
    assert _asdict(ref) == _asdict(pol)
    # under the reference's file name, its loader takes the record as is
    os.replace(st.policy_path(str(tmp_path), "cpu"),
               ref_st.policy_path(str(tmp_path), "cpu"))
    cached = ref_st.load_policy(str(tmp_path), "cpu", backend="pipelined")
    assert _asdict(cached) == dict(_asdict(pol), source="cached")


def _synth(seed=0, m=40, dim=12):
    rng = np.random.default_rng(seed)
    return LabeledDataset(
        features=rng.standard_normal((m, dim)) + 1.0,
        labels=rng.integers(0, 4, m),
        times=rng.uniform(0.01, 0.1, (m, 4)),
        order_times=np.full((m, 4), 0.001),
        fills=np.ones((m, 4), np.int64), flops=np.ones((m, 4), np.int64),
        names=[f"m{i}" for i in range(m)], groups=["g"] * m,
        dims=np.full(m, 100), nnzs=np.full(m, 500),
        algorithms=list(LABEL_ALGORITHMS))


@pytest.mark.parametrize("policy", [
    dict(bs=16, pad="mult8", sweep_bs=16, rt=8),
    dict(bs=64, pad="pow2", sweep_bs=64, rt=None)], ids=["mult8", "bs64"])
def test_engine_applies_a_saved_policy(tmp_path, policy):
    """A tuned record in ``autotune_dir`` is applied with ``autotune_solve``
    off: ``execute_plan`` gets its knobs (``plan.meta``), and the kwargs
    equal the reference engine's over the same record."""
    fields = dict(FULL, **policy)
    st.save_policy(st.SolvePolicy(**fields), str(tmp_path / "port"))
    ref_st.save_policy(ref_st.SolvePolicy(**fields), str(tmp_path / "ref"))
    port = SolverEngine(EngineConfig(
        model="decision_tree", path="host", fast_grids=True, cv=3,
        device="cpu", autotune_dir=str(tmp_path / "port")))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        ref = RefEngine(RefConfig(
            backend="pipelined", sweep="device", solve_dtype="fp32_refine",
            cache_dir=None, autotune_dir=str(tmp_path / "ref")))
    got, want = port._solve_kwargs(), ref._solve_kwargs()
    assert got.pop("device") == "cpu"
    assert got.pop("metrics") is port.metrics
    assert want.pop("metrics") is ref.metrics
    assert got == want
    assert port.solve_policy.source == "cached"
    port.train(_synth())
    a = grid2d(8, 8, "g8")
    b = np.random.default_rng(1).standard_normal(a.n)
    r = port.solve(a, b)
    plan = port.plan(a)
    assert (plan.meta["solve_bs"], plan.meta["solve_pad"]) == (
        policy["bs"], policy["pad"])
    assert (r["bs"], r["pad"], r["rt"]) == (policy["bs"], policy["pad"],
                                            policy["rt"])
    assert r["refine_converged"] and r["residual"] <= 1e-10
    assert np.linalg.norm(a.matvec(r["x"]) - b) <= 1e-10 * np.linalg.norm(b)


def test_engine_without_a_record_uses_the_default_policy(tmp_path):
    port = SolverEngine(EngineConfig(device="cpu",
                                     autotune_dir=str(tmp_path)))
    pol = port.solve_policy
    assert pol.source == "default" and pol.device_kind == "cpu"
    kw = port._solve_kwargs()
    assert (kw["pad"], kw["bs"], kw["sweep_bs"], kw["rt"]) == (
        "pow2", None, None, None)
    assert os.listdir(tmp_path) == []  # autotune_solve off: nothing tuned


def test_engine_autotunes_once_then_loads(tmp_path, monkeypatch):
    """``autotune_solve=True`` tunes on the first access (on the config's
    device) and persists; a second engine on the same directory loads the
    record and measures nothing."""
    tuned = []
    real = st.tune

    def small_tune(**kw):
        tuned.append(kw)
        return real(mats=_mats(), **dict(kw, **TINY))

    monkeypatch.setattr(st, "tune", small_tune)
    cfg = dict(device="cpu", autotune_solve=True, autotune_dir=str(tmp_path))
    first = SolverEngine(EngineConfig(**cfg)).solve_policy
    assert first.source == "tuned" and len(tuned) == 1
    assert tuned[0]["device"] == "cpu" and tuned[0]["backend"] == "pipelined"
    second = SolverEngine(EngineConfig(**cfg)).solve_policy
    assert second.source == "cached" and len(tuned) == 1
    assert dataclasses.replace(second, source="tuned") == first
