"""The port's per-front tile kernels (``chol_tile``, ``tri_inv_tile``,
``matmul_nt``) and the ``ops`` functions over them against the reference on
the same numpy inputs (seeded). The port runs the kernels' plain versions on
the CPU; the reference runs its Pallas kernels in interpret mode.

Tolerances: the tile kernels 1e-5 relative to the largest magnitude in f32
(other summation orders); ``frontal_factor`` 1e-4 as
``tests/test_kernels.py`` holds it (its Schur block is a difference of
larger sums). The f32 SpMV 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import frontal_cholesky as ref_fc  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.sparse.dataset import banded  # noqa: E402

from repro_torch.kernels import KERNELS  # noqa: E402
from repro_torch.kernels import frontal_cholesky as fc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"max abs err {err:.3e}, scale {scale:.3e}"


def _spd(rng, m):
    g = rng.standard_normal((m, m))
    return (g @ g.T / m + 2 * np.eye(m)).astype(np.float32)


@pytest.mark.parametrize("bs", [8, 16, 32, 33, 100, 128])
def test_chol_tile_matches_pallas(bs):
    rng = np.random.default_rng(bs)
    a = _spd(rng, bs)
    want = np.asarray(ref_fc.chol_tile(a, interpret=True))
    got = fc.chol_tile(torch.from_numpy(a.copy()))
    _close(got, want)
    assert not np.triu(got.numpy(), 1).any()


@pytest.mark.parametrize("bs", [8, 32, 33, 100, 128])
def test_chol_tile_reads_only_the_lower_triangle(bs):
    """After the first panel the upper triangle of the workspace holds the
    full-square update's garbage: neither package may read it."""
    rng = np.random.default_rng(100 + bs)
    a = _spd(rng, bs)
    junk = np.tril(a) + np.triu(rng.standard_normal((bs, bs)) * 1e3, 1)
    junk = junk.astype(np.float32)
    want = np.asarray(ref_fc.chol_tile(a, interpret=True))
    _close(np.asarray(ref_fc.chol_tile(junk, interpret=True)), want)
    # a strided view of a larger workspace, as ops.frontal_factor passes it
    W = torch.zeros((bs + 5, bs + 9))
    W[3 : 3 + bs, 7 : 7 + bs] = torch.from_numpy(junk)
    _close(fc.chol_tile(W[3 : 3 + bs, 7 : 7 + bs]), want)


def test_chol_tile_non_positive_pivot_gives_nan():
    a = torch.eye(8)
    a[3, 3] = -1.0
    assert torch.isnan(fc.chol_tile(a)[3, 3])


@pytest.mark.parametrize("bs", [8, 16, 32])
def test_tri_inv_tile_matches_pallas(bs):
    rng = np.random.default_rng(200 + bs)
    low = np.linalg.cholesky(_spd(rng, bs).astype(np.float64))
    junk = (low + np.triu(rng.standard_normal((bs, bs)), 1)).astype(np.float32)
    want = np.asarray(ref_fc.tri_inv_tile(junk, interpret=True))
    got = fc.tri_inv_tile(torch.from_numpy(junk.copy()))
    _close(got, want)
    _close(got.numpy() @ np.tril(junk), np.eye(bs), 1e-5)


@pytest.mark.parametrize("bs", [1, 33, 100, 128])
def test_tri_inv_tile_at_ragged_and_full_widths_matches_pallas(bs):
    """The CUDA kernel pads bs to 1, 2 or 4 diagonal blocks of 32: one
    block (1), a ragged second (33), a ragged fourth (100) and the path's
    full 128, each with garbage above the diagonal that must not be read."""
    rng = np.random.default_rng(400 + bs)
    low = np.linalg.cholesky(_spd(rng, bs).astype(np.float64))
    junk = (low + np.triu(rng.standard_normal((bs, bs)) * 1e3, 1)).astype(
        np.float32)
    want = np.asarray(ref_fc.tri_inv_tile(junk, interpret=True))
    got = fc.tri_inv_tile(torch.from_numpy(junk.copy()))
    _close(got, want)
    assert not np.triu(got.numpy(), 1).any()
    _close(got.numpy() @ np.tril(junk), np.eye(bs), 1e-5)


@pytest.mark.parametrize("m,n,k,alpha,beta", [
    (1152, 128, 128, 1.0, 0.0),    # the root's panel L21 = W21 L11^-T
    (1152, 1152, 128, -1.0, 1.0),  # the root's trailing update
    (128, 128, 128, -1.0, 1.0),    # a leaf front's trailing update
    (200, 136, 72, 0.5, 2.0),      # ragged in M, N and K
])
def test_matmul_nt_path_shapes_match_padded_reference(m, n, k, alpha, beta):
    rng = np.random.default_rng(m + 7 * n + 13 * k)
    a, b, c = (rng.standard_normal(s).astype(np.float32)
               for s in ((m, k), (n, k), (m, n)))
    want = np.asarray(ref_ops.matmul_nt_padded(a, b, c, alpha=alpha,
                                               beta=beta))
    got = fc.matmul_nt(*(torch.from_numpy(t) for t in (a, b, c)),
                       alpha=alpha, beta=beta)
    _close(got, want)


def test_matmul_nt_unaligned_views_in_place_match_padded_reference():
    """Row strides and offsets that are not 16-byte multiples (the kernel's
    4-byte copy path), written in place into a view of c's workspace."""
    rng = np.random.default_rng(11)
    m, n, k = 200, 136, 72
    A = torch.from_numpy(rng.standard_normal((m, k + 3)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((n, k + 5)).astype(np.float32))
    C = torch.from_numpy(rng.standard_normal((m, n + 2)).astype(np.float32))
    a, b, c = A[:, 1 : 1 + k], B[:, 2 : 2 + k], C[:, 1 : 1 + n]
    want = np.asarray(ref_ops.matmul_nt_padded(a.numpy(), b.numpy(),
                                               c.numpy(), alpha=-1.0,
                                               beta=1.0))
    before = C.clone()
    fc.matmul_nt(a, b, c, alpha=-1.0, beta=1.0, out=c)
    _close(C[:, 1 : 1 + n], want)
    assert torch.equal(C[:, 0], before[:, 0])
    assert torch.equal(C[:, 1 + n :], before[:, 1 + n :])


@pytest.mark.parametrize("bs", [8, 16, 32])
@pytest.mark.parametrize("alpha,beta", [(1.0, 0.0), (-1.0, 1.0), (0.5, 2.0)])
def test_matmul_nt_matches_pallas(bs, alpha, beta):
    rng = np.random.default_rng(300 + bs)
    M, N, K = 3 * bs, 2 * bs, 2 * bs
    a, b, c = (rng.standard_normal(s).astype(np.float32)
               for s in ((M, K), (N, K), (M, N)))
    want = np.asarray(ref_fc.matmul_nt(a, b, c, alpha=alpha, beta=beta,
                                       bm=bs, bn=bs, bk=bs, interpret=True))
    got = fc.matmul_nt(*(torch.from_numpy(t) for t in (a, b, c)),
                       alpha=alpha, beta=beta)
    _close(got, want)


def test_matmul_nt_beta_zero_still_reads_c():
    """beta = 0 forms 0·c, as the reference's ``beta * c`` does."""
    a, b = torch.ones((8, 4)), torch.ones((8, 4))
    c = torch.zeros((8, 8))
    c[2, 5] = float("nan")
    out = fc.matmul_nt(a, b, c, alpha=1.0, beta=0.0)
    assert torch.isnan(out[2, 5]) and out[0, 0] == 4.0


def test_matmul_nt_writes_in_place_into_a_strided_view():
    rng = np.random.default_rng(7)
    W = torch.from_numpy(rng.standard_normal((24, 24)).astype(np.float32))
    before = W.clone()
    panel, trail = W[8:, :8], W[8:, 8:]
    out = fc.matmul_nt(panel, panel, trail, alpha=-1.0, beta=1.0, out=trail)
    assert out.data_ptr() == trail.data_ptr()
    _close(W[8:, 8:], before[8:, 8:] - before[8:, :8] @ before[8:, :8].T)
    assert torch.equal(W[:, :8], before[:, :8])


def test_matmul_nt_padded_matches_reference():
    rng = np.random.default_rng(8)
    a, b, c = (rng.standard_normal(s).astype(np.float32)
               for s in ((64, 32), (48, 32), (64, 48)))
    want = np.asarray(ref_ops.matmul_nt_padded(a, b, c, alpha=-1.0, beta=1.0,
                                               bs=16))
    got = ops.matmul_nt_padded(*(torch.from_numpy(t) for t in (a, b, c)),
                               alpha=-1.0, beta=1.0)
    _close(got, want)


@pytest.mark.parametrize("m,npiv,bs", [
    (8, 3, 8), (24, 24, 8), (40, 17, 16), (65, 1, 32), (70, 33, 32),
])
def test_frontal_factor_matches_reference(m, npiv, bs):
    rng = np.random.default_rng(m * 100 + npiv)
    g = rng.standard_normal((m, m))
    f = g @ g.T + m * np.eye(m)
    want = [np.asarray(t) for t in ref_ops.frontal_factor(f, npiv, bs=bs)]
    got = ops.frontal_factor(torch.from_numpy(f), npiv, bs=bs)
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    for g_, w in zip(got, want):
        if w.size:
            _close(g_, w, 1e-4)
    S = got[2].numpy()
    np.testing.assert_array_equal(S, S.T)


def test_frontal_factor_batch_matches_reference():
    rng = np.random.default_rng(9)
    fs = np.stack([_spd(rng, 20) for _ in range(3)])
    want = [np.asarray(t) for t in ref_ops.frontal_factor_batch(fs, 6)]
    got = ops.frontal_factor_batch(torch.from_numpy(fs), 6)
    for g_, w in zip(got, want):
        _close(g_, w)


def test_spmv_matches_reference():
    rng = np.random.default_rng(10)
    m = banded(64, 3, 0.7, rng, "b")
    x = rng.standard_normal(64)
    want = ref_ops.spmv(m.indptr, m.indices, m.data, x, bs=8)
    got = ops.spmv(m.indptr, m.indices, m.data, x, bs=8, device="cpu")
    _close(got, want)


def test_tile_kernels_are_registered_and_count_only_cuda_launches():
    """The three wrappers are in KERNELS, and a CPU call (the plain
    version) counts no launch."""
    for name in ("chol_tile", "tri_inv_tile", "matmul_nt"):
        assert KERNELS[name] is getattr(fc, name)
    before = {n: KERNELS[n].launches for n in KERNELS}
    fc.matmul_nt(torch.eye(8), torch.eye(8), torch.eye(8))
    fc.tri_inv_tile(fc.chol_tile(torch.eye(8)))
    assert {n: KERNELS[n].launches for n in KERNELS} == before
    with pytest.raises(ValueError, match="square tile"):
        fc.chol_tile(torch.eye(130))


def test_build_compiles_every_source_and_binds_the_tile_ops():
    """One load() call builds every source in csrc/, the new
    tile_kernels.cu among them, and the binding registers the three ops."""
    from repro_torch.kernels import _build

    csrc = _build._CSRC
    assert set(_build.SOURCES) == {p.name for p in csrc.glob("*.cu")} | {
        "bindings.cpp"}
    binding = (csrc / "bindings.cpp").read_text()
    header = (csrc / "kernels.h").read_text()
    for op in ("chol_tile", "tri_inv_tile", "matmul_nt"):
        assert f'm.def("{op}(' in binding or f'"{op}(' in binding, op
        assert f"launch_{op}(" in header, op


def test_chip_smoke_sweep_lists_every_per_front_product(monkeypatch):
    """``chip_smoke.per_front_products``, which sets the card's matmul_nt
    sweep, gives exactly the (rows, N, K) that ``ops.frontal_factor``
    launches and how often, on fronts with one and two pivot panels, a
    ragged update block and none."""
    import importlib.util
    import pathlib
    import types

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    seen = {}
    real = fc.matmul_nt

    def spy(a, b, c, **kw):
        key = (a.shape[0], b.shape[0], a.shape[1])
        seen[key] = seen.get(key, 0) + 1
        return real(a, b, c, **kw)

    monkeypatch.setattr(fc, "matmul_nt", spy)
    fronts = [(200, 150), (140, 20), (64, 64), (129, 128)]
    rng = np.random.default_rng(12)
    for m, npiv in fronts:
        ops.frontal_factor(torch.from_numpy(_spd(rng, m)), npiv)
    sched = types.SimpleNamespace(fronts=[
        types.SimpleNamespace(npiv=p, nrest=m - p) for m, p in fronts])
    assert chip_smoke.per_front_products(sched) == seen
    # the first front: a 256-row panel step, then a 128-row one; the next
    # two 128-row steps; the third has no update block, so no product
    assert seen == {(128, 128, 128): 6, (256, 128, 128): 1,
                    (256, 256, 128): 1}


def test_tile_kernels_info_and_matmul_plan_are_bound():
    """The resource and launch-plan ops that chip_smoke.py logs are bound,
    and both kernel files share one diagonal-tile inverse."""
    from repro_torch.kernels import _build

    csrc = _build._CSRC
    binding = (csrc / "bindings.cpp").read_text()
    header = (csrc / "kernels.h").read_text()
    assert '"tile_kernels_info(int i) -> int[]"' in binding
    assert '"matmul_nt_plan(int M, int N) -> int[]"' in binding
    assert "int tile_kernel_info(int i, int out[8]);" in header
    assert "void matmul_nt_plan(int M, int N, int out[4]);" in header
    for src in ("tile_kernels.cu", "tri_solve.cu"):
        assert '#include "tile_invert.cuh"' in (csrc / src).read_text(), src
    assert "void invert_tile(" in (csrc / "tile_invert.cuh").read_text()


def test_frontal_factor_info_is_bound_and_both_factors_share_one_step():
    """The resource op that chip_smoke.py logs for frontal_factor_batch is
    bound, and both Cholesky kernels take their diagonal block's factor from
    one header; chol_tile forms the inverse beside it, the batched factor
    after it."""
    from repro_torch.kernels import _build

    csrc = _build._CSRC
    binding = (csrc / "bindings.cpp").read_text()
    header = (csrc / "kernels.h").read_text()
    assert '"frontal_factor_info(int i) -> int[]"' in binding
    assert "int frontal_factor_kernel_info(int i, int out[8]);" in header
    for src in ("frontal_factor.cu", "tile_kernels.cu"):
        text = (csrc / src).read_text()
        assert '#include "tile_chol.cuh"' in text, src
        assert "tile::chol_cols<" in text, src
    assert "tile::invert_tile<" in (csrc / "frontal_factor.cu").read_text()
    assert "tile::inv_cols<" in (csrc / "tile_kernels.cu").read_text()
    header = (csrc / "tile_chol.cuh").read_text()
    assert "void chol_cols(" in header and "void inv_cols(" in header
