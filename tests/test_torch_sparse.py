"""The port's host modules against the reference's, on the same matrices:
CSR utilities, the paper's four label orderings, the symbolic factor and
the level schedule must agree exactly."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.sparse import csr as ref_csr  # noqa: E402
from repro.sparse import reorder as ref_reorder  # noqa: E402
from repro.sparse import schedule as ref_schedule  # noqa: E402
from repro.sparse import symbolic as ref_symbolic  # noqa: E402
from repro.sparse.dataset import grid2d as ref_grid2d  # noqa: E402
from repro.sparse.dataset import grid3d as ref_grid3d  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.sparse import csr, dataset, reorder, schedule, symbolic  # noqa: E402

LABELS = ["amd", "scotch", "nd", "rcm"]


def _port(a):
    """The reference CSRMatrix as the port's (same arrays)."""
    return csr.CSRMatrix(a.indptr, a.indices, a.data, a.shape, a.name,
                         a.group)


def _same_csr(x, y):
    np.testing.assert_array_equal(x.indptr, y.indptr)
    np.testing.assert_array_equal(x.indices, y.indices)
    np.testing.assert_array_equal(x.data, y.data)
    assert tuple(x.shape) == tuple(y.shape)


def test_grid_generators_match_reference():
    _same_csr(dataset.grid2d(5, 7, "g"), ref_grid2d(5, 7, "g"))
    _same_csr(dataset.grid3d(3, 4, 5, "g"), ref_grid3d(3, 4, 5, "g"))


def test_csr_utilities_match_reference(small_suite):
    rng = np.random.default_rng(0)
    for a in small_suite:
        pa = _port(a)
        _same_csr(csr.make_spd(pa), ref_csr.make_spd(a))
        _same_csr(csr.symmetrize_pattern(pa), ref_csr.symmetrize_pattern(a))
        perm = rng.permutation(a.n)
        _same_csr(csr.permute_symmetric(pa, perm),
                  ref_csr.permute_symmetric(a, perm))
        x = rng.standard_normal((a.n, 2))
        np.testing.assert_array_equal(pa.matvec(x), a.matvec(x))
        np.testing.assert_array_equal(pa.matvec(x[:, 0]), a.matvec(x[:, 0]))


@pytest.mark.parametrize("algorithm", LABELS + ["natural"])
def test_label_orderings_match_reference(small_suite, algorithm):
    for a in small_suite:
        got = reorder.get_reordering(algorithm)(_port(a))
        want = ref_reorder.get_reordering(algorithm)(a)
        np.testing.assert_array_equal(got, want, err_msg=a.name)


def test_unknown_ordering_raises():
    with pytest.raises(KeyError, match="known"):
        reorder.get_reordering("metis")


@pytest.mark.parametrize("algorithm", LABELS)
@pytest.mark.parametrize("pad", ["pow2", "mult8"])
def test_symbolic_and_schedule_match_reference(small_suite, algorithm, pad):
    for a in small_suite:
        a = ref_csr.make_spd(a)
        perm = ref_reorder.get_reordering(algorithm)(a)
        ra = ref_csr.permute_symmetric(a, perm)
        want = ref_symbolic.symbolic_cholesky(ra)
        got = symbolic.symbolic_cholesky(_port(ra))
        for field in ("parent", "counts", "Lp", "Li"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        assert (got.flops, got.fill) == (want.flops, want.fill)
        for x, y in zip(symbolic.supernodes(got), ref_symbolic.supernodes(want)):
            np.testing.assert_array_equal(x, y)
        gs = schedule.build_schedule(got, pad=pad)
        ws = ref_schedule.build_schedule(want, pad=pad)
        assert gs.nlevels == ws.nlevels and gs.nsup == ws.nsup
        for gl, wl in zip(gs.buckets, ws.buckets):
            assert [(b.P, b.R, b.members) for b in gl] == \
                [(b.P, b.R, b.members) for b in wl]
        for gf, wf in zip(gs.fronts, ws.fronts):
            assert (gf.k, gf.c0, gf.c1, gf.parent, gf.level) == \
                (wf.k, wf.c0, wf.c1, wf.parent, wf.level)
            np.testing.assert_array_equal(gf.rows, wf.rows)
        gst, wst = gs.stats(), ws.stats()
        assert gst == wst
        assert gs.sweep_flops(3) == ws.sweep_flops(3)


def test_pad_policy_and_block_policy_match_reference():
    for x in range(0, 300):
        for pad in ("pow2", "mult8"):
            assert schedule._pad_dim(x, pad) == ref_schedule._pad_dim(x, pad)
        for cap in (None, 8, 16, 24, 32):
            assert ops.pick_block_size(max(x, 1), cap) == \
                ref_ops.pick_block_size(max(x, 1), cap)
        for rt in (None, 2, 3, 8):
            assert ops.rhs_tile(x, rt) == ref_ops.rhs_tile(x, rt)
