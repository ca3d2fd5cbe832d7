"""The port's other solve paths against the reference on the same matrices
and right-hand sides (seeded numpy): the ``numpy``, ``pallas`` and
``batched`` backends, the ``seq``/``level``/``device`` sweeps, every new
``execute_plan`` combination, the simplicial solver,
``factor_and_solve_timed`` and the labeling campaign. The port runs its
plain kernel versions here (``device="cpu"``); the reference runs its
Pallas kernels in interpret mode.

Tolerances: fp64 ``numpy`` factors and host sweeps 1e-8 relative; the f32
backends and f32 sweeps without refinement 1e-4 (f32, other summation
orders, and the pallas backend's 128-padded tiles). Refined solutions 1e-8
relative with residual ≤ 1e-10, against the reference's host refinement
(its device refinement runs in f32 on this jax build)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import labeling as ref_labeling  # noqa: E402
from repro.core.plan import PlanBuilder as RefPlanBuilder  # noqa: E402
from repro.core.plan import execute_plan as ref_execute_plan  # noqa: E402
from repro.sparse import multifrontal as ref_mf  # noqa: E402
from repro.sparse import numeric as ref_numeric  # noqa: E402
from repro.sparse.csr import make_spd  # noqa: E402
from repro.sparse.dataset import generate_suite as ref_generate_suite  # noqa: E402
from repro.sparse.dataset import grid2d  # noqa: E402

from repro_torch.convert import plan_arrays, plan_from_arrays  # noqa: E402
from repro_torch.core import labeling  # noqa: E402
from repro_torch.core.plan import execute_plan  # noqa: E402
from repro_torch.sparse import csr, numeric  # noqa: E402
from repro_torch.sparse import multifrontal as mf  # noqa: E402
from repro_torch.sparse.dataset import generate_suite  # noqa: E402


def _port(a):
    return csr.CSRMatrix(a.indptr, a.indices, a.data, a.shape, a.name,
                         a.group)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"max abs err {err:.3e}, scale {scale:.3e}"


def _same_fronts(port, ref, rtol):
    assert len(port.fronts) == len(ref.fronts)
    for got, want in zip(port.fronts, ref.fronts):
        assert got.cols == want.cols
        np.testing.assert_array_equal(got.rows, want.rows)
        _close(got.L11, want.L11, rtol)
        if want.L21.size:
            _close(got.L21, want.L21, rtol)


@pytest.fixture(scope="module")
def grid():
    return make_spd(grid2d(12, 12, "g12"))


@pytest.fixture(scope="module")
def small():
    """The reference's per-front pallas backend takes seconds per front in
    interpret mode: compare it on one small grid only."""
    a = make_spd(grid2d(6, 6, "g6"))
    return a, ref_mf.multifrontal_cholesky(a, backend="pallas")


@pytest.fixture(scope="module")
def ref_numpy(grid):
    return ref_mf.multifrontal_cholesky(grid, backend="numpy")


def test_numpy_backend_matches_reference(grid, ref_numpy):
    port = mf.multifrontal_cholesky(_port(grid), backend="numpy")
    assert port.device is None and port.dtype == np.float64
    _same_fronts(port, ref_numpy, 1e-8)
    f32 = mf.multifrontal_cholesky(_port(grid), backend="numpy",
                                   dtype=np.float32)
    assert f32.fronts[0].L11.dtype == np.float32
    _same_fronts(f32, ref_numpy, 1e-4)


def test_pallas_backend_matches_reference(small):
    a, ref = small
    port = mf.multifrontal_cholesky(_port(a), backend="pallas", device="cpu")
    assert port.device_stacks is None and port.dtype == np.float32
    _same_fronts(port, ref, 1e-4)
    for key in ("t_factor_assemble", "t_factor_sync", "t_factor_schedule"):
        assert port.stats[key] >= 0.0, key
    assert port.stats["backend"] == ref.stats["backend"] == "pallas"


def test_pallas_backend_matches_reference_numpy_backend(grid, ref_numpy):
    port = mf.multifrontal_cholesky(_port(grid), backend="pallas",
                                    device="cpu")
    _same_fronts(port, ref_numpy, 1e-4)


def test_batched_backend_matches_reference(grid):
    ref = ref_mf.multifrontal_cholesky(grid, backend="batched")
    port = mf.multifrontal_cholesky(_port(grid), backend="batched",
                                    device="cpu")
    _same_fronts(port, ref, 1e-4)
    for key in ("nsup", "nlevels", "nbatches", "peak_front", "nnz_L",
                "backend", "dtype"):
        assert port.stats[key] == ref.stats[key], key


@pytest.mark.parametrize("mode", ["seq", "level", "auto"])
@pytest.mark.parametrize("k", [None, 3])
def test_host_sweeps_match_reference(grid, ref_numpy, mode, k):
    rng = np.random.default_rng(11)
    b = rng.standard_normal(grid.n if k is None else (grid.n, k))
    port = mf.multifrontal_cholesky(_port(grid), backend="numpy")
    want = ref_mf.multifrontal_solve(ref_numpy, b, mode=mode)
    got = mf.multifrontal_solve(port, b, mode=mode)
    assert got.shape == b.shape and got.dtype == np.float64
    _close(got, want, 1e-8)


@pytest.mark.parametrize("backend", ["numpy", "pallas", "batched"])
def test_device_sweeps_after_host_fronts_match_reference(grid, backend):
    """``sweep="device"`` after a backend that leaves its fronts on the
    host: the fronts are stacked and uploaded once."""
    b = np.random.default_rng(12).standard_normal((grid.n, 2))
    ref = ref_mf.multifrontal_cholesky(grid, backend="batched")
    want = ref_mf.multifrontal_solve(ref, b, mode="device")
    port = mf.multifrontal_cholesky(_port(grid), backend=backend,
                                    device="cpu")
    got = mf.multifrontal_solve(port, b, mode="device")
    _close(got, want, 1e-4)
    again = mf.multifrontal_solve(port, b, mode="device")  # cached stacks
    np.testing.assert_array_equal(again, got)


def test_pipelined_factor_runs_the_host_sweeps(grid, ref_numpy):
    b = np.random.default_rng(13).standard_normal(grid.n)
    port = mf.multifrontal_cholesky(_port(grid), device="cpu")
    want = ref_mf.multifrontal_solve(ref_numpy, b, mode="seq")
    for mode in ("seq", "level"):
        _close(mf.multifrontal_solve(port, b, mode=mode), want, 1e-4)


@pytest.mark.parametrize("backend", ["pipelined", "numpy"])
def test_default_sweep_is_the_device_sweep(grid, backend):
    """Without ``mode`` the solve runs the device sweeps, as the factor's
    default is the device backend (the reference defaults to ``auto``);
    after host fronts it stacks them in f32 and builds no host sweeps."""
    b = np.random.default_rng(14).standard_normal(grid.n)
    port = mf.multifrontal_cholesky(_port(grid), backend=backend,
                                    device="cpu")
    got = mf.multifrontal_solve(port, b)
    assert port._dev_sweeps is not None and port._sweeps is None
    np.testing.assert_array_equal(
        got, mf.multifrontal_solve(port, b, mode="device"))


def test_numpy_factor_resolves_its_sweep_device_on_first_use(grid):
    port = mf.multifrontal_cholesky(_port(grid), backend="numpy",
                                    device="cpu")
    assert str(port.device) == "cpu"
    host = mf.multifrontal_cholesky(_port(grid), backend="numpy")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mf.multifrontal_solve(host, np.ones(grid.n), mode="device")


#: (execute_plan keywords of the port, of the reference); the reference
#: refines on the host (sweep="level") where the port refines on the device
COMBOS = {
    "numpy-fp64": (dict(backend="numpy", solve_dtype="fp64", sweep="auto"),
                   dict(backend="numpy", solve_dtype="fp64", sweep="auto")),
    "pallas-fp32_refine": (
        dict(backend="pallas", solve_dtype="fp32_refine", sweep="device"),
        dict(backend="pallas", solve_dtype="fp32_refine", sweep="auto")),
    "batched-level": (dict(backend="batched", sweep="level"),
                      dict(backend="batched", sweep="level")),
    "pipelined-seq": (dict(backend="pipelined", sweep="seq"),
                      dict(backend="pipelined", sweep="seq")),
    "simplicial": (dict(solver="simplicial", backend="numpy"),
                   dict(solver="simplicial")),
}
#: effective (solve_dtype, sweep) each combination reports
EFFECTIVE = {"numpy-fp64": ("fp64", "level"),
             "pallas-fp32_refine": ("fp32_refine", "device"),
             "batched-level": ("fp32_refine", "level"),
             "pipelined-seq": ("fp32_refine", "seq"),
             "simplicial": ("fp64", "seq")}


@pytest.mark.parametrize("combo", list(COMBOS))
def test_execute_plan_combination_matches_reference(small, combo):
    a = small[0]
    port_kw, ref_kw = COMBOS[combo]
    b = np.random.default_rng(14).standard_normal(a.n)
    ref_plan = RefPlanBuilder().build(a, "nd")
    plan = plan_from_arrays(**plan_arrays(ref_plan))
    want = ref_execute_plan(a, ref_plan, b, **ref_kw)
    got = execute_plan(_port(a), plan, b, device="cpu", **port_kw)
    _close(got["x"], want["x"], 1e-8)
    assert got["residual"] <= 1e-10 and want["residual"] <= 1e-10
    assert (got["solve_dtype"], got["sweep"]) == EFFECTIVE[combo]
    refined = got["solve_dtype"] == "fp32_refine"
    assert got["refine_converged"] is (True if refined else None)
    for key in ("solve_backend", "solve_dtype", "solve_bs", "solve_pad"):
        assert plan.meta[key] == ref_plan.meta[key], key
    assert plan.meta["solve_sweep"] == got["sweep"]
    assert set(want) - {"request_id"} <= set(got)


def test_execute_plan_fp32_level_is_unrefined(grid):
    b = np.random.default_rng(15).standard_normal(grid.n)
    ref_plan = RefPlanBuilder().build(grid, "amd")
    plan = plan_from_arrays(**plan_arrays(ref_plan))
    want = ref_execute_plan(grid, ref_plan, b, backend="numpy",
                            solve_dtype="fp32", sweep="level")
    got = execute_plan(_port(grid), plan, b, backend="numpy",
                       solve_dtype="fp32", sweep="level", device="cpu")
    assert got["refine_iterations"] is None and got["solve_dtype"] == "fp32"
    _close(got["x"], want["x"], 1e-4)
    assert set(got["spans"]) == {"permute", "factor", "factor.schedule",
                                 "solve", "solve.sweep"}


def test_execute_plan_rejects_unknown_values(grid):
    plan = plan_from_arrays(**plan_arrays(RefPlanBuilder().build(grid, "nd")))
    for kw in (dict(sweep="bogus"), dict(solver="bogus"),
               dict(backend="bogus")):
        with pytest.raises(ValueError):
            execute_plan(_port(grid), plan, np.ones(grid.n), device="cpu",
                         **kw)


def test_simplicial_and_skyline_match_reference(grid):
    b = np.random.default_rng(16).standard_normal(grid.n)
    ref = ref_numeric.sparse_cholesky(grid)
    port = numeric.sparse_cholesky(_port(grid))
    _close(port.Lx, ref.Lx, 1e-12)
    _close(numeric.cholesky_solve(port, b),
           ref_numeric.cholesky_solve(ref, b), 1e-12)
    ref_sky = ref_numeric.skyline_cholesky(grid)
    sky = numeric.skyline_cholesky(_port(grid))
    assert sky.flops == ref_sky.flops
    _close(numeric.skyline_solve(sky, b),
           ref_numeric.skyline_solve(ref_sky, b), 1e-12)


def test_csr_from_dense_matches_reference():
    from repro.sparse.csr import csr_from_dense as ref_csr_from_dense

    d = np.random.default_rng(17).standard_normal((9, 9))
    d[np.abs(d) < 0.8] = 0.0
    got, want = csr.csr_from_dense(d, "d"), ref_csr_from_dense(d, "d")
    for key in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))


def test_factor_and_solve_timed_matches_reference(grid):
    want = ref_mf.factor_and_solve_timed(grid)
    got = mf.factor_and_solve_timed(_port(grid))
    assert set(got) - set(want) == {"t_factor_schedule"}
    assert set(want) <= set(got)
    assert got["backend"] == "numpy" and got["residual"] <= 1e-12
    for key in ("nsup", "nnz_L", "fill", "sym_flops", "dtype"):
        assert got[key] == want[key], key
    assert got["t_symbolic"] > 0
    sym = mf.symbolic_cholesky(_port(grid))
    again = mf.factor_and_solve_timed(_port(grid), sym=sym, sweep="seq")
    assert again["t_symbolic"] == 0.0 and again["residual"] <= 1e-12


def test_labeling_campaign_matches_reference(tmp_path):
    mats = list(ref_generate_suite(3, seed=2, size_scale=0.3))
    port_mats = list(generate_suite(3, seed=2, size_scale=0.3))
    want = ref_labeling.run_labeling_campaign(mats)
    got = labeling.run_labeling_campaign(port_mats)
    for key in ("features", "fills", "flops", "dims", "nnzs"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key),
                                      err_msg=key)
    assert got.names == want.names and got.algorithms == want.algorithms
    assert (got.times > 0).all() and (got.order_times > 0).all()
    np.testing.assert_array_equal(got.labels, got.times.argmin(1))
    # the .npz loads in both packages
    path = str(tmp_path / "port.npz")
    got.save(path)
    back = ref_labeling.LabeledDataset.load(path)
    np.testing.assert_array_equal(back.features, got.features)
    want.save(str(tmp_path / "ref.npz"))
    assert labeling.LabeledDataset.load(str(tmp_path / "ref.npz")).names \
        == want.names


def test_load_or_build_writes_the_reference_cache(tmp_path):
    kw = dict(count=2, seed=3, size_scale=0.3, verbose=False)
    ds = labeling.load_or_build(str(tmp_path / "port"), **kw)
    ref_ds = ref_labeling.load_or_build(str(tmp_path / "ref"), **kw)
    name = "labels_c2_s3_x0.3_r1"
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir()) == \
        [f"{name}.json", f"{name}.npz"]
    side = json.loads((tmp_path / "port" / f"{name}.json").read_text())
    ref_side = json.loads((tmp_path / "ref" / f"{name}.json").read_text())
    assert side.keys() == ref_side.keys()
    assert (side["count"], side["n_max"], side["nnz_max"]) == (
        ref_side["count"], ref_side["n_max"], ref_side["nnz_max"])
    np.testing.assert_array_equal(ds.features, ref_ds.features)
    # a second call reads the cache, written by either package
    again = labeling.load_or_build(str(tmp_path / "ref"), **kw)
    np.testing.assert_array_equal(again.times, ref_ds.times)
