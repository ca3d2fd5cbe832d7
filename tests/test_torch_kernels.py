"""The plain PyTorch version of each ported kernel against the reference
Pallas kernel in interpret mode, on the same numpy inputs (seeded).

Tolerances: f32 ~1e-5 relative to the largest magnitude — the two sum in
other orders (the reference multiplies by the inverse of each diagonal
tile, the port substitutes). The factor's Schur block is compared on its
lower triangle only: that triangle is authoritative in both packages. The
fp64 SpMV is held against a numpy dense product at 1e-12."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import frontal_cholesky as ref_fc  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.spmv_bell import bell_spmv as ref_bell_spmv  # noqa: E402
from repro.kernels.spmv_bell import csr_to_bell as ref_csr_to_bell  # noqa: E402

from repro_torch.kernels import frontal_cholesky as fc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.spmv_bell import bell_spmv, csr_to_bell  # noqa: E402

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"max abs err {err:.3e}, scale {scale:.3e}"


def _spd_fronts(rng, B, M):
    w = np.zeros((B, M, M), np.float32)
    for b in range(B):
        g = rng.standard_normal((M, M)) / np.sqrt(M)
        w[b] = np.tril(g @ g.T + 2 * np.eye(M))
    return w


@pytest.mark.parametrize("B,M,npiv,bs", [(3, 24, 16, 8), (2, 40, 32, 16),
                                         (1, 32, 32, 32), (2, 48, 24, 8),
                                         (2, 56, 40, 20), (3, 5, 3, 3),
                                         (1, 64, 64, 32), (4, 16, 8, 8)])
def test_frontal_factor_plain_matches_pallas(B, M, npiv, bs):
    rng = np.random.default_rng(B * 1000 + M)
    w = _spd_fronts(rng, B, M)
    want = np.asarray(ref_fc.frontal_factor_batch(w, npiv, bs=bs,
                                                  interpret=True))
    got = fc.frontal_factor_batch(torch.from_numpy(w.copy()), npiv, bs=bs)
    _close(np.tril(got.numpy()), np.tril(want))


def test_frontal_factor_ws_picks_the_reference_block_size():
    rng = np.random.default_rng(7)
    w = _spd_fronts(rng, 2, 56)
    want = np.asarray(ref_ops.frontal_factor_batch_ws(w, 40))  # bs -> 20
    got = ops.frontal_factor_batch_ws(torch.from_numpy(w.copy()), 40)
    _close(np.tril(got.numpy()), np.tril(want))


def _extend_inputs(rng, B, M, C, R):
    w = rng.standard_normal((B, M, M)).astype(np.float32)
    u = rng.standard_normal((C, R, R)).astype(np.float32)
    dst = np.sort(rng.integers(0, B, C)).astype(np.int32)
    rows = np.full((C, R), -1, dtype=np.int32)
    for c in range(C):
        k = int(rng.integers(1, R + 1))
        rows[c, :k] = np.sort(rng.choice(M, size=k, replace=False))
    return w, u, dst, rows


@pytest.mark.parametrize("B,M,C,R", [(3, 16, 6, 8), (2, 24, 5, 16)])
def test_extend_add_plain_matches_pallas(B, M, C, R):
    rng = np.random.default_rng(C * 100 + R)
    w, u, dst, rows = _extend_inputs(rng, B, M, C, R)
    want = np.asarray(ref_fc.extend_add_batch(w, u, dst, rows,
                                              interpret=True))
    got = fc.extend_add_batch(torch.from_numpy(w.copy()), torch.from_numpy(u),
                              dst, rows)
    _close(got.numpy(), want)


def test_extend_add_reads_u_through_src_and_offset():
    """U[c] = u[src[c], off:off+R, off:off+R] equals the reference fed the
    gathered blocks (what the pipelined backend's jnp.take built)."""
    rng = np.random.default_rng(3)
    w, _, dst, rows = _extend_inputs(rng, 3, 16, 6, 8)
    stack = rng.standard_normal((4, 12, 12)).astype(np.float32)
    src = rng.integers(0, 4, 6).astype(np.int32)
    u = stack[src, 4:, 4:]
    want = np.asarray(ref_fc.extend_add_batch(w, u, dst, rows,
                                              interpret=True))
    got = fc.extend_add_batch(torch.from_numpy(w.copy()),
                              torch.from_numpy(stack), dst, rows, src=src,
                              off=4)
    _close(got.numpy(), want)


def test_extend_add_rejects_unsorted_destinations():
    w = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError, match="sorted"):
        fc.extend_add_batch(w, torch.zeros((2, 4, 4)), [1, 0],
                            np.zeros((2, 4), np.int32))


def _source_groups(rng, B, M, specs):
    """Seeded source groups of a grouped extend-add: per (C, R, Bu, Mu,
    off) a factored-stack stand-in (Bu, Mu, Mu) and C contributions."""
    groups = []
    for C, R, Bu, Mu, off in specs:
        _, _, dst, rows = _extend_inputs(rng, B, M, C, R)
        stack = rng.standard_normal((Bu, Mu, Mu)).astype(np.float32)
        groups.append((stack, off, rng.integers(0, Bu, C).astype(np.int32),
                       dst, rows))
    return groups


# (B, M, groups as (C, R, Bu, Mu, off)): stacks of different Mu and
# offsets, row maps of different widths (R not a multiple of 4 included)
GROUPED = [(3, 24, [(5, 8, 3, 12, 4), (4, 5, 2, 11, 3), (3, 16, 4, 20, 4)]),
           (2, 40, [(6, 12, 4, 20, 8), (2, 7, 2, 9, 1)])]


@pytest.mark.parametrize("B,M,specs", GROUPED, ids=["3-groups", "2-groups"])
def test_extend_add_routed_plain_matches_pallas_group_by_group(B, M, specs):
    """The grouped extend-add's plain path (the routing interpreter) equals
    the reference kernel applied group by group to the gathered blocks."""
    rng = np.random.default_rng(M)
    w = rng.standard_normal((B, M, M)).astype(np.float32)
    groups = _source_groups(rng, B, M, specs)
    want = w
    for stack, off, src, dst, rows in groups:
        R = rows.shape[1]
        want = np.asarray(ref_fc.extend_add_batch(
            want, stack[src, off : off + R, off : off + R], dst, rows,
            interpret=True))
    routing = fc.extend_add_routing(
        [(M, [(src, dst, rows) for _, _, src, dst, rows in groups])])
    got = fc.extend_add_routed(torch.from_numpy(w.copy()),
                               [torch.from_numpy(g[0]) for g in groups],
                               [g[1] for g in groups], routing, 0)
    _close(got.numpy(), want)


def test_extend_add_routing_splits_groups_over_launches():
    """A destination with more source groups than one launch's table
    holds takes further launches, in group order; the interpreter gives the
    bits of the per-group plain calls."""
    rng = np.random.default_rng(11)
    B, M = 4, 32
    groups = _source_groups(rng, B, M, [(3, 6, 2, 10, 4)] * 70)
    routing = fc.extend_add_routing(
        [(M, [(src, dst, rows) for _, _, src, dst, rows in groups])])
    assert [(ln.g0, ln.g1) for ln in routing.launches[0]] == [
        (0, 32), (32, 64), (64, 70)]
    w0 = torch.from_numpy(rng.standard_normal((B, M, M)).astype(np.float32))
    stacks = [torch.from_numpy(g[0]) for g in groups]
    got = fc.extend_add_routed(w0.clone(), stacks, [g[1] for g in groups],
                               routing, 0)
    want = w0.clone()
    for stack, (_, off, src, dst, rows) in zip(stacks, groups):
        fc.extend_add_batch_plain(want, stack, dst, rows, src, off)
    assert torch.equal(got, want)


def test_extend_add_routing_layout():
    """The routing's sections as the kernel reads them: row maps at
    multiples of 4 ints, padded with -1; each destination row once, its
    entries in contribution order; each row's span covers its columns."""
    rng = np.random.default_rng(5)
    B, M = 3, 20
    groups = _source_groups(rng, B, M, [(6, 5, 2, 9, 2), (4, 8, 3, 12, 4)])
    dests = [(M, [(src, dst, rows) for _, _, src, dst, rows in groups])]
    routing = fc.extend_add_routing(dests)
    maps, ent, rows, span = (t.numpy() for t in routing.sections())
    assert routing.data.dtype == torch.int32 and maps.size % 4 == 0
    assert np.all(ent[:, 1] % 4 == 0)
    contribs = [(g, c) for g, grp in enumerate(groups)
                for c in range(grp[4].shape[0])]
    seen = {}
    for r in range(rows.shape[0] - 1):
        e0, e1 = rows[r, 1], rows[r + 1, 1]
        assert e1 > e0 and rows[r, 0] not in seen
        seen[rows[r, 0]] = r
        cols = []
        for x, moff, R, i in ent[e0:e1]:
            g = x & (fc.EA_MAX_GROUPS - 1)
            m = maps[moff : moff + R]
            assert m[i] == rows[r, 0] % M        # the U row lands here
            cols.append(m[m >= 0])
        order = [next(k for k, (gg, c) in enumerate(contribs) if gg == g)
                 for g in (ent[e0:e1, 0] & (fc.EA_MAX_GROUPS - 1))]
        assert order == sorted(order)
        if e1 - e0 > 1:
            allc = np.concatenate(cols)
            assert span[r] & 0xFFFF == allc.min()
            assert span[r] >> 16 == allc.max() + 1
    # every active (contribution, U row) pair appears once
    assert rows[-1, 1] == sum(int((g[4] >= 0).sum()) for g in groups)


def test_extend_add_routed_checks_its_stacks():
    rng = np.random.default_rng(2)
    groups = _source_groups(rng, 2, 16, [(3, 6, 2, 10, 4)])
    routing = fc.extend_add_routing(
        [(16, [(src, dst, rows) for _, _, src, dst, rows in groups])])
    w = torch.zeros((2, 16, 16))
    with pytest.raises(ValueError, match="does not fit"):
        fc.extend_add_routed(w, [torch.zeros((1, 10, 10))], [4], routing, 0)
    with pytest.raises(ValueError, match="does not fit"):
        fc.extend_add_routed(w, [torch.zeros((2, 10, 10))], [5], routing, 0)
    with pytest.raises(ValueError, match="destination 0"):
        fc.extend_add_routed(torch.zeros((2, 17, 17)),
                             [torch.zeros((2, 10, 10))], [4], routing, 0)
    with pytest.raises(ValueError, match="out of range"):
        fc.extend_add_routing([(16, [(np.zeros(1), np.zeros(1),
                                      np.full((1, 3), 16))])])


# (P, bs, K): the first two at P = 32, bs = 8; then every pivot width the
# CUDA kernel's two variants meet on the solve path at its panel width
# (ops.pick_block_size) and RHS counts of 1, 8 and 33 (a ragged 32 + 1 tile)
TRI_SOLVE_SHAPES = [(32, 8, 1), (32, 8, 5)] + [
    (P, ops.pick_block_size(P), K) for P in (8, 32, 64) for K in (1, 8, 33)]


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize(
    "P,bs,K", TRI_SOLVE_SHAPES,
    ids=["1", "5"] + [f"P{P}-bs{bs}-K{K}" for P, bs, K in TRI_SOLVE_SHAPES[2:]])
def test_tri_solve_plain_matches_pallas(lower, P, bs, K):
    rng = np.random.default_rng(K)
    B = 3
    l = np.tril(rng.standard_normal((B, P, P))).astype(np.float32)
    l += 4 * np.eye(P, dtype=np.float32)
    x = rng.standard_normal((B, P, K)).astype(np.float32)
    want = np.asarray(ref_fc.tri_solve_batch(l, x, bs=bs, lower=lower,
                                             interpret=True))
    # upper-triangle garbage must be ignored: the port reads only tril(l)
    noisy = l + np.triu(rng.standard_normal((B, P, P)), 1).astype(np.float32)
    got = fc.tri_solve_batch(torch.from_numpy(noisy),
                             torch.from_numpy(x.copy()), bs=bs, lower=lower)
    _close(got.numpy(), want)


@pytest.mark.parametrize("lower", [True, False])
def test_tri_solve_plain_matches_scipy_at_the_root_width(lower):
    """P = 256 in panels of 32 (the 32³ schedule's root bucket), held
    against a float64 triangular solve on tril(l) rather than the Pallas
    kernel in interpret mode, which is slow at this size."""
    scipy_linalg = pytest.importorskip("scipy.linalg")
    rng = np.random.default_rng(256)
    P, K = 256, 3
    g = rng.standard_normal((P, P)) / np.sqrt(P)
    l = np.linalg.cholesky(g @ g.T + 2 * np.eye(P))[None]
    x = rng.standard_normal((1, P, K))
    want = scipy_linalg.solve_triangular(l[0], x[0], lower=True,
                                         trans=0 if lower else 1)
    noisy = (l + np.triu(rng.standard_normal((1, P, P)), 1)).astype(np.float32)
    got = fc.tri_solve_batch(torch.from_numpy(noisy),
                             torch.from_numpy(x.astype(np.float32)),
                             bs=ops.pick_block_size(P), lower=lower)
    _close(got[0].numpy(), want)


def test_ops_tri_solve_leaves_input_and_matches_reference_policy():
    rng = np.random.default_rng(11)
    l = np.tril(rng.standard_normal((2, 24, 24))).astype(np.float32)
    l += 4 * np.eye(24, dtype=np.float32)
    x = rng.standard_normal((2, 24, 3)).astype(np.float32)
    want = np.asarray(ref_ops.tri_solve_batch(l, x, rt=2, lower=False))
    xt = torch.from_numpy(x.copy())
    got = ops.tri_solve_batch(torch.from_numpy(l), xt, rt=2, lower=False)
    _close(got.numpy(), want)
    np.testing.assert_array_equal(xt.numpy(), x)


def _random_csr(rng, n, density):
    a = (rng.random((n, n)) < density) * rng.standard_normal((n, n))
    a += np.eye(n)
    indptr = np.r_[0, np.cumsum((a != 0).sum(1))].astype(np.int32)
    indices = np.nonzero(a)[1].astype(np.int32)
    return a, indptr, indices, a[a != 0]


def _bell_case(name, rng, n=37):
    """A seeded CSR matrix: random, with an empty row, with a long row, or
    with an entry stored twice (a row's last entry again at its end)."""
    a, _, _, _ = _random_csr(rng, n, 0.1)
    if name == "empty_row":
        a[n // 3] = 0.0
    elif name == "long_row":
        a[n // 2] = rng.standard_normal(n)
    indptr = np.r_[0, np.cumsum((a != 0).sum(1))].astype(np.int32)
    indices = np.nonzero(a)[1].astype(np.int32)
    data = a[a != 0]
    if name == "duplicate":
        end = indptr[5]
        indices = np.insert(indices, end, indices[end - 1])
        data = np.insert(data, end, 7.0)
        indptr = indptr + (np.arange(n + 1) >= 5)
    return a, indptr, indices, data


@pytest.mark.parametrize("bs", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("case", ["random", "empty_row", "long_row",
                                  "duplicate"])
def test_csr_to_bell_matches_reference(case, bs):
    _, indptr, indices, data = _bell_case(case, np.random.default_rng(5))
    got = csr_to_bell(indptr, indices, data, 37, bs)
    want = ref_csr_to_bell(indptr, indices, data, 37, bs)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k,bs", [
    pytest.param(None, 8, id="None"), pytest.param(4, 8, id="4"),
    *(pytest.param(k, bs, id=f"{k}-bs{bs}")
      for bs in (1, 2, 4) for k in (None, 4))])
def test_bell_spmv_plain_matches_pallas_f32(k, bs):
    rng = np.random.default_rng(6)
    n = 37
    _, indptr, indices, data = _random_csr(rng, n, 0.1)
    blocks, idx, npad = csr_to_bell(indptr, indices, data, n, bs)
    x = rng.standard_normal(npad if k is None else (npad, k)).astype(np.float32)
    want = np.asarray(ref_bell_spmv(blocks.astype(np.float32), idx, x,
                                    interpret=True))
    got = bell_spmv(torch.from_numpy(blocks.astype(np.float32)),
                    torch.from_numpy(idx), torch.from_numpy(x))
    assert got.shape == x.shape
    _close(got.numpy(), want)


def _stored_bytes(indptr, indices, n, bs):
    blocks, idx, _ = csr_to_bell(indptr, indices,
                                 np.ones(indices.size), n, bs)
    return blocks.nbytes + idx.nbytes


@pytest.mark.parametrize("name", ["grid3d", "band", "random", "long_row"])
def test_pick_spmv_bs_stores_the_fewest_bytes(name):
    from repro.sparse.dataset import grid3d

    from repro_torch.kernels.spmv_bell import SPMV_BLOCK_SIZES, pick_spmv_bs

    rng = np.random.default_rng(9)
    if name == "grid3d":
        g = grid3d(6, 6, 6, "g")
        indptr, indices, n = g.indptr, g.indices, g.n
    else:
        n = 64
        if name == "band":   # a full band of half-width 6: 2x2 blocks fill
            a = (np.abs(np.subtract.outer(np.arange(n), np.arange(n))) <= 6
                 ).astype(float)
        else:
            a, _, _, _ = _bell_case(name, rng, n)
        indptr = np.r_[0, np.cumsum((a != 0).sum(1))].astype(np.int32)
        indices = np.nonzero(a)[1].astype(np.int32)
    sizes = {bs: _stored_bytes(indptr, indices, n, bs)
             for bs in SPMV_BLOCK_SIZES}
    bs = pick_spmv_bs(indptr, indices, n)
    assert sizes[bs] == min(sizes.values())
    assert bs == min(b for b, v in sizes.items() if v == sizes[bs])
    assert bs == {"grid3d": 1, "band": 2}.get(name, bs)


@pytest.mark.parametrize("k", [None, 3])
def test_bell_spmv_fp64_matches_dense_product(k):
    rng = np.random.default_rng(8)
    n = 45
    a, indptr, indices, data = _random_csr(rng, n, 0.08)
    blocks, idx, npad = csr_to_bell(indptr, indices, data, n, 8)
    x = np.zeros(npad if k is None else (npad, k))
    x[:n] = rng.standard_normal(x[:n].shape)
    got = bell_spmv(torch.from_numpy(blocks), torch.from_numpy(idx),
                    torch.from_numpy(x))
    assert got.dtype == torch.float64
    _close(got.numpy()[:n], a @ x[:n], rtol=1e-12)
