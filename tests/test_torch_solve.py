"""The port's numeric path against the reference on the same matrices and
right-hand sides (seeded numpy): the pipelined factor, the device sweeps,
the fp64 refinement and ``execute_plan`` as a whole, plus plans carried
across with :mod:`repro_torch.convert`. The port runs its plain kernel
versions here (``device="cpu"``); the reference runs its Pallas kernels in
interpret mode.

Tolerances: factors and f32 sweeps 1e-5 relative (f32, other summation
orders). Refined solutions 1e-8 relative and residuals 1e-10, against the
reference's ``sweep="level"`` refinement, which takes its residual in fp64
on the host (its device refinement runs in f32 on this jax build)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.plan import PlanBuilder as RefPlanBuilder  # noqa: E402
from repro.core.plan import execute_plan as ref_execute_plan  # noqa: E402
from repro.core.plan_cache import matrix_fingerprint as ref_fingerprint  # noqa: E402
from repro.sparse import multifrontal as ref_mf  # noqa: E402
from repro.sparse.csr import CSRMatrix as RefCSRMatrix  # noqa: E402
from repro.sparse.csr import make_spd  # noqa: E402
from repro.sparse.dataset import block_arrow, grid2d, grid3d  # noqa: E402
from repro.sparse.refine import refine_solve as ref_refine_solve  # noqa: E402

from repro_torch.convert import plan_arrays, plan_from_arrays  # noqa: E402
from repro_torch.core.plan import SOLVE_STAGES, PlanBuilder, execute_plan  # noqa: E402
from repro_torch.sparse import csr  # noqa: E402
from repro_torch.kernels import frontal_cholesky as fc  # noqa: E402
from repro_torch.sparse import multifrontal as mf  # noqa: E402
from repro_torch.sparse.refine import RefineInfo, refine_solve_device  # noqa: E402

LABELS = ["amd", "scotch", "nd", "rcm"]


def _port(a):
    return csr.CSRMatrix(a.indptr, a.indices, a.data, a.shape, a.name,
                         a.group)


def _close(got, want, rtol):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= rtol * scale, f"max abs err {err:.3e}, scale {scale:.3e}"


def _residual(a, x, b):
    return float(np.linalg.norm(a.matvec(x) - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def spd_grid():
    return make_spd(grid2d(12, 12, "g12"))


@pytest.fixture(scope="module")
def factors(spd_grid):
    return (ref_mf.multifrontal_cholesky(spd_grid, backend="pipelined"),
            mf.multifrontal_cholesky(_port(spd_grid), device="cpu"))


def test_pipelined_fronts_match_reference(factors):
    ref, port = factors
    assert len(port.fronts) == len(ref.fronts)
    for got, want in zip(port.fronts, ref.fronts):
        assert got.cols == want.cols
        np.testing.assert_array_equal(got.rows, want.rows)
        _close(got.L11, want.L11, 1e-5)
        if want.L21.size:
            _close(got.L21, want.L21, 1e-5)


def test_pipelined_stats_match_reference(factors):
    ref, port = factors
    for key in ("t_factor_assemble", "t_factor_dispatch", "t_factor_sync",
                "overlap_efficiency", "t_factor_schedule"):
        assert key in port.stats
    for key in ("nsup", "nlevels", "nbatches", "occupancy", "front_flops",
                "peak_front", "nnz_L", "fill", "sym_flops", "backend"):
        assert port.stats[key] == ref.stats[key], key


def test_pipelined_mult8_fronts_match_reference():
    a = make_spd(block_arrow(3, 20, 8, np.random.default_rng(0), "arrow"))
    ref = ref_mf.multifrontal_cholesky(a, backend="pipelined", pad="mult8")
    port = mf.multifrontal_cholesky(_port(a), pad="mult8", device="cpu")
    for got, want in zip(port.fronts, ref.fronts):
        _close(got.L11, want.L11, 1e-5)
        if want.L21.size:
            _close(got.L21, want.L21, 1e-5)


def test_device_routing_reproduces_route_contributions():
    """grid3d(6,6,6) under nd: the port's routes equal the reference's, and
    the device routing built from them (one launch per fed bucket), applied
    by its plain interpreter to seeded source stacks, gives the bits of the
    per-group plain calls the first design made, in their order."""
    a = grid3d(6, 6, 6, "g6")
    pa = csr.permute_symmetric(_port(a), PlanBuilder().build(_port(a),
                                                             "nd").perm)
    ref = ref_mf.multifrontal_cholesky(
        RefCSRMatrix(pa.indptr, pa.indices, pa.data, pa.shape, pa.name),
        backend="numpy")
    sched = mf.multifrontal_cholesky(pa, device="cpu").schedule
    routes = mf._route_contributions(sched)
    ref_routes = ref_mf._route_contributions(ref.schedule)
    assert routes.keys() == ref_routes.keys()
    for key, groups in routes.items():
        assert groups.keys() == ref_routes[key].keys()
        for skey, contribs in groups.items():
            for (s, d, m), (rs, rd, rm) in zip(contribs, ref_routes[key][skey],
                                               strict=True):
                assert (s, d) == (rs, rd)
                np.testing.assert_array_equal(m, rm)
    routing, fed = mf._device_routing(sched)
    assert fed.keys() == routes.keys()
    assert [len(routing.launches[d]) for d, _ in fed.values()] == [
        -(-len(routes[k]) // fc.EA_MAX_GROUPS) for k in fed]
    rng = np.random.default_rng(6)
    stacks = {(li, bj): torch.from_numpy(rng.standard_normal(
        (len(bk.members), bk.M, bk.M)).astype(np.float32))
        for li in range(sched.nlevels)
        for bj, bk in enumerate(sched.buckets[li])}
    for key, (d, skeys) in fed.items():
        got = stacks[key].clone()
        fc.extend_add_routed_plain(
            got, [stacks[k] for k in skeys],
            [sched.buckets[k[0]][k[1]].P for k in skeys], routing, d)
        want = stacks[key].clone()
        for skey in sorted(routes[key]):
            contribs = sorted(routes[key][skey], key=lambda c: c[1])
            fc.extend_add_batch_plain(
                want, stacks[skey], np.array([c[1] for c in contribs]),
                np.stack([c[2] for c in contribs]),
                np.array([c[0] for c in contribs]),
                sched.buckets[skey[0]][skey[1]].P)
        assert torch.equal(got, want), key


def test_device_routing_of_fronts_without_update_rows():
    """A diagonal matrix: every front is a root, so nothing is routed and
    the pipelined factor launches no extend-add."""
    n = 5
    a = csr.CSRMatrix(np.arange(n + 1, dtype=np.int32),
                      np.arange(n, dtype=np.int32), np.arange(1.0, n + 1),
                      (n, n), "diag")
    f = mf.multifrontal_cholesky(a, device="cpu")
    routing, fed = mf._device_routing(f.schedule)
    assert fed == {} and routing.sizes == (0, 0, 0) and routing.launches == []
    x = mf.multifrontal_solve(f, np.ones(n))
    np.testing.assert_allclose(x, 1.0 / np.arange(1.0, n + 1), rtol=1e-6)


@pytest.mark.parametrize("k", [None, 3])
def test_device_sweeps_match_reference(factors, spd_grid, k):
    ref, port = factors
    rng = np.random.default_rng(4)
    b = rng.standard_normal(spd_grid.n if k is None else (spd_grid.n, k))
    want = ref_mf.multifrontal_solve(ref, b, mode="device")
    got = mf.multifrontal_solve(port, b, mode="device")
    assert got.shape == b.shape and got.dtype == np.float64
    _close(got, want, 1e-5)


def test_unported_modes_raise(factors, spd_grid):
    """Every mode and backend of the reference is ported now: the ones this
    test once saw refused run and agree with the reference, and only
    unknown names raise."""
    ref, port = factors
    b = np.ones(spd_grid.n)
    _close(mf.multifrontal_solve(port, b, mode="level"),
           ref_mf.multifrontal_solve(ref, b, mode="level"), 1e-5)
    batched = mf.multifrontal_cholesky(_port(spd_grid), backend="batched",
                                       device="cpu")
    assert batched.stats["backend"] == "batched"
    _close(mf.multifrontal_solve(batched, b, mode="device"),
           ref_mf.multifrontal_solve(ref, b, mode="device"), 1e-5)
    with pytest.raises(ValueError, match="unknown sweep mode"):
        mf.multifrontal_solve(port, b, mode="bogus")
    with pytest.raises(ValueError, match="unknown backend"):
        mf.multifrontal_cholesky(_port(spd_grid), backend="bogus",
                                 device="cpu")


@pytest.mark.parametrize("k,spmv_bs", [
    pytest.param(None, None, id="None"), pytest.param(2, None, id="2"),
    pytest.param(None, 8, id="None-bs8"), pytest.param(2, 8, id="2-bs8")])
def test_refine_solve_device_matches_host_refinement(factors, spd_grid, k,
                                                     spmv_bs):
    """The picked residual layout (``spmv_bs=None``) and the reference's
    (bs = 8) both reach the host refinement."""
    ref, port = factors
    rng = np.random.default_rng(5)
    b = rng.standard_normal(spd_grid.n if k is None else (spd_grid.n, k))
    want, _ = ref_refine_solve(
        spd_grid.matvec,
        lambda r: ref_mf.multifrontal_solve(ref, r, mode="level"), b)
    got, info = refine_solve_device(_port(spd_grid), port, b,
                                    spmv_bs=spmv_bs)
    assert info.converged and info.final_residual <= 1e-12
    assert info.iterations >= 1 and len(info.residuals) == info.iterations + 1
    _close(got, want, 1e-8)
    assert _residual(spd_grid, got, b) <= 1e-10


def test_refine_zero_rhs_is_zero(factors, spd_grid):
    x, info = refine_solve_device(_port(spd_grid), factors[1],
                                  np.zeros(spd_grid.n))
    assert not x.any() and info == RefineInfo(0, [0.0], True)
    assert "t_setup" in {f.name for f in dataclasses.fields(RefineInfo)}


@pytest.mark.parametrize("algorithm", LABELS)
def test_execute_plan_matches_reference(spd_grid, algorithm):
    rng = np.random.default_rng(6)
    b = rng.standard_normal(spd_grid.n)
    ref_plan = RefPlanBuilder().build(spd_grid, algorithm)
    want = ref_execute_plan(spd_grid, ref_plan, b, backend="pipelined",
                            sweep="level", solve_dtype="fp32_refine")
    plan = plan_from_arrays(**plan_arrays(ref_plan))
    got = execute_plan(_port(spd_grid), plan, b, device="cpu")
    _close(got["x"], want["x"], 1e-8)
    assert got["residual"] <= 1e-10
    assert _residual(spd_grid, got["x"], b) <= 1e-10
    assert got["refine_converged"] and got["solve_dtype"] == "fp32_refine"
    for key in ("solve_backend", "solve_dtype", "solve_bs", "solve_pad"):
        assert plan.meta[key] == ref_plan.meta[key], key
    assert plan.meta["solve_sweep"] == "device"
    assert set(got["spans"]) == set(SOLVE_STAGES)
    assert set(want) - {"request_id"} <= set(got)


def test_execute_plan_multi_rhs_and_fp64_promotion(spd_grid):
    rng = np.random.default_rng(7)
    b = rng.standard_normal((spd_grid.n, 3))
    plan = PlanBuilder().build(_port(spd_grid), "nd")
    ref_plan = RefPlanBuilder().build(spd_grid, "nd")
    want = ref_execute_plan(spd_grid, ref_plan, b, backend="pipelined",
                            sweep="level", solve_dtype="fp32_refine")
    got = execute_plan(_port(spd_grid), plan, b, solve_dtype="fp64",
                       device="cpu")
    assert got["x"].shape == b.shape and got["solve_dtype"] == "fp32_refine"
    _close(got["x"], want["x"], 1e-8)
    assert _residual(spd_grid, got["x"], b) <= 1e-10


def test_execute_plan_fp32_without_refinement(spd_grid):
    b = np.random.default_rng(8).standard_normal(spd_grid.n)
    plan = PlanBuilder().build(_port(spd_grid), "amd")
    got = execute_plan(_port(spd_grid), plan, b, solve_dtype="fp32",
                       device="cpu")
    assert got["refine_iterations"] is None and got["residual"] <= 1e-5
    assert "solve.refine" not in got["spans"]


def test_plan_builder_matches_reference(spd_grid):
    port_plan = PlanBuilder().build(_port(spd_grid), "scotch")
    ref_plan = RefPlanBuilder().build(spd_grid, "scotch")
    assert port_plan.fingerprint == ref_fingerprint(spd_grid)
    got, want = plan_arrays(port_plan), plan_arrays(ref_plan)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert port_plan.predicted_flops == ref_plan.predicted_flops
    assert port_plan.nnz_L == ref_plan.nnz_L and port_plan.n == ref_plan.n


def test_convert_round_trips_a_reference_plan(spd_grid):
    ref_plan = RefPlanBuilder().build(spd_grid, "rcm")
    plan = plan_from_arrays(**plan_arrays(ref_plan))
    back = plan_arrays(plan)
    for key, value in plan_arrays(ref_plan).items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    assert plan.sym.nnz_L == ref_plan.sym.nnz_L
    assert plan.predicted_flops == ref_plan.predicted_flops


_PANEL_MATS = {}


def _panel_case(name):
    """grid2d(12, 12) and grid3d(7, 7, 7) (pivot widths up to 64 under
    ``pow2`` and 48 under ``mult8``) with their ``nd`` plans, for both
    packages."""
    if name not in _PANEL_MATS:
        a = (grid2d(12, 12, "g12") if name == "grid2d"
             else grid3d(7, 7, 7, "g7"))
        _PANEL_MATS[name] = (a, RefPlanBuilder().build(a, "nd"))
    return _PANEL_MATS[name]


@pytest.mark.parametrize("sweep_bs", [None, 16, 64])
@pytest.mark.parametrize("pad", ["pow2", "mult8"])
@pytest.mark.parametrize("bs", [16, 32, 64, None])
def test_panel_cap_matches_the_kernels(monkeypatch, bs, pad, sweep_bs):
    """``ops.pick_block_size`` caps every panel at ``fc.MAX_PANEL`` (the
    kernels' 32): whatever ``bs``/``sweep_bs`` the reference accepts, the
    factor and the sweeps hand the kernel wrappers a panel of at most 32,
    and a wider one raises on the CPU as the binding does on the card. At
    ``bs = sweep_bs = 64`` the port equals the reference under the same
    knobs: factors within 1e-5 relative, refined solutions within 1e-8 of
    the reference's host refinement (its device refinement runs in f32 on
    this jax build)."""
    from repro_torch.kernels import ops

    panels = []
    factor, sweep = fc.frontal_factor_batch, fc.tri_solve_batch

    def rec_factor(w, npiv, *, bs):
        panels.append(("factor", npiv, bs))
        return factor(w, npiv, bs=bs)

    def rec_sweep(l, x, *, bs, kt=None, lower=True):
        panels.append(("sweep", l.shape[1], bs))
        return sweep(l, x, bs=bs, kt=kt, lower=lower)

    monkeypatch.setattr(fc, "frontal_factor_batch", rec_factor)
    monkeypatch.setattr(fc, "tri_solve_batch", rec_sweep)
    rng = np.random.default_rng(9)
    for name in ("grid2d", "grid3d"):
        a, ref_plan = _panel_case(name)
        plan = plan_from_arrays(**plan_arrays(ref_plan))
        b = rng.standard_normal(a.n)
        got = execute_plan(_port(a), plan, b, pad=pad, bs=bs,
                           sweep_bs=sweep_bs, device="cpu")
        assert got["refine_converged"] and got["residual"] <= 1e-10
        if bs == 64 and sweep_bs == 64:
            pa = csr.permute_symmetric(_port(a), plan.perm)
            ref_pa = RefCSRMatrix(pa.indptr, pa.indices, pa.data, pa.shape,
                                  pa.name)
            ref = ref_mf.multifrontal_cholesky(ref_pa, sym=ref_plan.sym,
                                               backend="pipelined", pad=pad,
                                               bs=64)
            port = mf.multifrontal_cholesky(pa, sym=plan.sym, pad=pad,
                                            bs=64, device="cpu")
            for g, w in zip(port.fronts, ref.fronts, strict=True):
                _close(g.L11, w.L11, 1e-5)
                if w.L21.size:
                    _close(g.L21, w.L21, 1e-5)
            pb = b[plan.perm]
            want, _ = ref_refine_solve(
                ref_pa.matvec,
                lambda r: ref_mf.multifrontal_solve(ref, r, mode="level"), pb)
            x = np.empty_like(want)
            x[plan.perm] = want
            _close(got["x"], x, 1e-8)
    widths = {(kind, P) for kind, P, _ in panels}
    assert {("factor", 64), ("sweep", 64)} <= widths or pad == "mult8"
    assert {("factor", 48), ("sweep", 48)} <= widths or pad == "pow2"
    assert max(p for _, _, p in panels) <= fc.MAX_PANEL == 32
    for kind, P, p in panels:
        cap = bs if kind == "factor" else sweep_bs
        assert p == ops.pick_block_size(P, min(cap or 32, 32)), (kind, P, p)

    w = torch.from_numpy(np.eye(66, dtype=np.float32)[None].copy())
    with pytest.raises(ValueError, match="bs must lie in"):
        factor(w, 33, bs=33)
    with pytest.raises(ValueError, match="bs must lie in"):
        sweep(w, torch.zeros((1, 66, 1)), bs=33)
