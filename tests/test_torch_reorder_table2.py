"""Table 2's nine orderings in the port against the reference, on small
seeded matrices: every permutation identical, the live category view, the
symbolic helpers ``fill_in`` and ``postorder``, the ``CSRMatrix`` helpers,
and an engine trained and served over a label set that includes ``md``.
All comparisons are exact."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.sparse import csr as ref_csr  # noqa: E402
from repro.sparse import reorder as ref_reorder  # noqa: E402
from repro.sparse import symbolic as ref_symbolic  # noqa: E402
from repro.sparse.dataset import grid2d as ref_grid2d  # noqa: E402
from repro.sparse.dataset import grid3d as ref_grid3d  # noqa: E402

import repro_torch.sparse as port_sparse  # noqa: E402
from repro_torch.sparse import csr, reorder, symbolic  # noqa: E402

TABLE2 = ["cm", "rcm", "md", "amd", "qamd", "amf", "nd", "scotch", "natural"]


def _ref_from_pattern(n, rows, cols, name):
    """SPD reference matrix on the symmetric pattern (rows, cols) + diag."""
    a = ref_csr.coo_to_csr(np.asarray(rows, np.int64),
                           np.asarray(cols, np.int64), None, (n, n), name)
    return ref_csr.make_spd(a)


def _matrices():
    rng = np.random.default_rng(23)
    mats = [_ref_from_pattern(1, [], [], "one"),
            _ref_from_pattern(6, [], [], "diagonal")]
    # two disconnected blocks: a 4-clique and a 5-path
    rows, cols = [], []
    for i in range(4):
        for j in range(4):
            if i != j:
                rows.append(i)
                cols.append(j)
    for i in range(4, 8):
        rows += [i, i + 1]
        cols += [i + 1, i]
    mats.append(_ref_from_pattern(9, rows, cols, "two_blocks"))
    # 8-row arrow: row/column 0 couples to every other
    rows = list(range(1, 8)) + [0] * 7
    cols = [0] * 7 + list(range(1, 8))
    mats.append(_ref_from_pattern(8, rows, cols, "arrow"))
    mats.append(ref_csr.make_spd(ref_grid2d(6, 6, "grid2d")))
    mats.append(ref_csr.make_spd(ref_grid3d(4, 4, 4, "grid3d")))
    mask = np.triu(rng.random((30, 30)) < 0.12, 1)
    r, c = np.nonzero(mask | mask.T)
    mats.append(_ref_from_pattern(30, r, c, "random30"))
    return mats


MATS = _matrices()


def _port(a):
    return csr.CSRMatrix(a.indptr, a.indices, a.data, a.shape, a.name,
                         a.group)


def test_every_table2_ordering_is_registered():
    assert sorted(reorder.REORDERINGS) == sorted(ref_reorder.REORDERINGS)
    assert sorted(reorder.REORDERINGS) == sorted(TABLE2)
    assert reorder.__all__ == ref_reorder.__all__
    assert reorder.LABEL_ALGORITHMS == ref_reorder.LABEL_ALGORITHMS


@pytest.mark.parametrize("algorithm", TABLE2)
def test_table2_permutations_match_reference(algorithm):
    for a in MATS:
        got = reorder.get_reordering(algorithm)(_port(a))
        want = ref_reorder.get_reordering(algorithm)(a)
        assert got.dtype == want.dtype, a.name
        np.testing.assert_array_equal(got, want, err_msg=a.name)
        np.testing.assert_array_equal(np.sort(got), np.arange(a.n))


def test_amd_is_the_approximate_branch():
    for a in MATS:
        pa = _port(a)
        np.testing.assert_array_equal(
            reorder.amd_order(pa),
            reorder.amd._quotient_md(pa, approximate=True, aggressive=False,
                                     min_fill=False), err_msg=a.name)


def test_category_view_matches_reference_including_late_registration():
    assert dict(reorder.CATEGORY_OF) == dict(ref_reorder.CATEGORY_OF)
    name = "test_table2_late"

    def late(a):
        return np.arange(a.n, dtype=np.int64)

    reorder.register_reordering(name, category="hybrid")(late)
    ref_reorder.register_reordering(name, category="hybrid")(late)
    try:
        assert reorder.CATEGORY_OF[name] == "hybrid"
        assert dict(reorder.CATEGORY_OF) == dict(ref_reorder.CATEGORY_OF)
        assert len(reorder.CATEGORY_OF) == len(ref_reorder.CATEGORY_OF)
    finally:
        reorder.REORDERING_REGISTRY.unregister(name)
        ref_reorder.REORDERING_REGISTRY.unregister(name)
    assert name not in reorder.CATEGORY_OF


@pytest.mark.parametrize("algorithm", ["natural", "md", "rcm"])
def test_fill_in_and_postorder_match_reference(algorithm):
    for a in MATS:
        perm = ref_reorder.get_reordering(algorithm)(a)
        ap = ref_csr.permute_symmetric(a, perm)
        pp = _port(ap)
        assert symbolic.fill_in(pp) == ref_symbolic.fill_in(ap), a.name
        parent = ref_symbolic.etree(ap)
        np.testing.assert_array_equal(symbolic.postorder(parent),
                                      ref_symbolic.postorder(parent),
                                      err_msg=a.name)


def test_csr_helpers_match_reference():
    for a in MATS:
        pa = _port(a)
        np.testing.assert_array_equal(pa.to_dense(), a.to_dense())
        assert pa.has_full_diagonal() == a.has_full_diagonal()
        for i in range(a.n):
            np.testing.assert_array_equal(pa.row_values(i), a.row_values(i))
        c = pa.copy()
        assert c is not pa and c.indices is not pa.indices
        np.testing.assert_array_equal(c.to_dense(), a.copy().to_dense())
        assert (c.name, c.group, c.shape) == (a.name, a.group, a.shape)
    # a pattern without a full diagonal, and a pattern-only matrix
    a = ref_csr.coo_to_csr(np.array([0, 1]), np.array([1, 0]), None, (3, 3))
    pa = _port(a)
    assert pa.has_full_diagonal() is a.has_full_diagonal() is False
    np.testing.assert_array_equal(pa.to_dense(), a.to_dense())


def test_sparse_package_exports_the_references():
    import repro.sparse as ref_sparse
    assert port_sparse.__all__ == ref_sparse.__all__
    for name in port_sparse.__all__:
        assert hasattr(port_sparse, name), name


def test_engine_trains_and_selects_with_md():
    from repro_torch.core.labeling import run_labeling_campaign
    from repro_torch.engine import EngineConfig, SolverEngine
    from repro_torch.sparse.dataset import generate_suite

    algs = ["amd", "scotch", "nd", "rcm", "md"]
    mats = list(generate_suite(12, seed=7, size_scale=0.25))
    ds = run_labeling_campaign(mats, algorithms=algs)
    eng = SolverEngine(EngineConfig(algorithms=algs, fast_grids=True, cv=3,
                                    device="cpu"))
    assert not eng.is_trained
    eng.train(ds)
    assert eng.is_trained
    names = eng.select_batch(mats[:6])
    assert len(names) == 6 and set(names) <= set(algs)
    host, _ = eng.selector.select_batch(mats[:6], path="host")
    assert names == host
    # a plan under md serves a solve
    from repro_torch.core.plan import execute_plan
    plan = eng.builder.build(mats[2], algorithm="md")
    assert plan.algorithm == "md"
    res = execute_plan(mats[2], plan, None, **eng._solve_kwargs())
    assert res["residual"] <= 1e-10
