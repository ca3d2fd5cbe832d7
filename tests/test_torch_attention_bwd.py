"""The attention backward's inputs from the forward, on the CPU: the plain
forward's statistics (the rows' log-sum-exp and the output's remainder)
against the reference's scores, and the wrapper's and the autograd
function's handling of them on the route to the card, with the launches
replaced so that nothing needs a card.

Inputs are numpy arrays from a seed, handed to both packages. Tolerances:
the log-sum-exp within 2e-6 of its magnitude (float32 sums of the same
scores in other orders); exp(s - L) within 1e-6 of the reference's
softmax (probabilities at most 1, float32 rounding of the exponent);
o + o_lo within 1e-5 of the largest float32 output (the remainder of a
bf16 rounding, itself rounded to bf16, keeps 16 significant bits: 2^-17
of each element, 7.6e-6)."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.ref import attention_ref  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402

# the module (``repro_torch.kernels`` exports its function of the same name)
fa = importlib.import_module("repro_torch.kernels.flash_attention")

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, b, hq, hkv, s, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]
    tdt, jdt = DTYPES[dtype]
    ts = [torch.from_numpy(a).to(tdt) for a in arrs]
    # the same values in both packages: round through the working dtype
    js = [jnp.asarray(t.float().numpy()).astype(jdt) for t in ts]
    return ts, js


def _ref_scores(q, k, causal, kv_len):
    """The reference's masked scores, as ``attention_ref`` forms them, on
    the grouped heads repeated to the query heads: (B, Hq, Sq, Skv)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    kr = jnp.repeat(k, hq // hkv, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32),
                   kr.astype(jnp.float32)) * (1.0 / d ** 0.5)
    mask = jnp.ones((sq, skv), dtype=bool)
    if kv_len is not None:
        mask = mask & (jnp.arange(skv)[None, :] < kv_len)
    if causal:
        mask = mask & (jnp.arange(sq)[:, None] >= jnp.arange(skv)[None, :])
    return jnp.where(mask[None, None], s, -1e30)


CASES = [  # (B, Hq, Hkv, S, D, causal, kv_len): GQA ratio 4, ragged S
    (2, 8, 2, 37, 16, True, None),
    (1, 4, 1, 70, 64, True, None),
    (2, 8, 2, 33, 32, False, 20),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_lse_is_the_logsumexp_of_the_reference_scores(case, dtype):
    b, hq, hkv, s, d, causal, kv_len = case
    (q, k, v), (jq, jk, _) = _inputs(s * d + hq, b, hq, hkv, s, d, dtype)
    out, lse, out_lo = fa.flash_attention_plain(
        q, k, v, causal=causal, kv_len=kv_len, stats=True)
    want = np.asarray(jax.nn.logsumexp(_ref_scores(jq, jk, causal, kv_len),
                                       axis=-1))
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, s)
    got = lse.numpy()
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    # the output is the one without statistics, bit for bit
    assert torch.equal(out, fa.flash_attention_plain(
        q, k, v, causal=causal, kv_len=kv_len))
    assert out_lo.dtype == q.dtype and out_lo.shape == q.shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_exp_of_the_scores_less_lse_is_the_reference_softmax(case, dtype):
    b, hq, hkv, s, d, causal, kv_len = case
    (q, k, v), (jq, jk, _) = _inputs(s + d, b, hq, hkv, s, d, dtype)
    _, lse, _ = fa.flash_attention_plain(q, k, v, causal=causal,
                                         kv_len=kv_len, stats=True)
    sc = _ref_scores(jq, jk, causal, kv_len)
    p = np.exp(np.asarray(sc, np.float64)
               - lse.numpy().astype(np.float64)[..., None])
    want = np.asarray(jax.nn.softmax(sc, axis=-1), np.float64)
    assert np.abs(p - want).max() <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_output_and_remainder_give_the_reference_output_in_float32(case,
                                                                   dtype):
    b, hq, hkv, s, d, causal, kv_len = case
    (q, k, v), (jq, jk, jv) = _inputs(3 * s + d, b, hq, hkv, s, d, dtype)
    out, _, out_lo = fa.flash_attention_plain(q, k, v, causal=causal,
                                              kv_len=kv_len, stats=True)
    rep = hq // hkv
    want = attention_ref(
        jq.astype(jnp.float32).reshape(b * hq, s, d),
        jnp.repeat(jk, rep, axis=1).astype(jnp.float32).reshape(b * hq, s, d),
        jnp.repeat(jv, rep, axis=1).astype(jnp.float32).reshape(b * hq, s, d),
        causal=causal, kv_len=kv_len)
    want = np.asarray(want).reshape(b, hq, s, d)
    got = (out.float() + out_lo.float()).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    if dtype == "float32":
        assert not bool(out_lo.any())


def _bad_stats(q):
    b, hq, s, d = q.shape
    lse = torch.zeros((b, hq, s))
    lo = torch.zeros_like(q)
    return {
        "lse shape": (dict(lse=lse[..., :-1], out_lo=lo), ValueError),
        "lse dtype": (dict(lse=lse.double(), out_lo=lo), TypeError),
        "lse device": (dict(lse=lse.to("meta"), out_lo=lo), ValueError),
        "out_lo shape": (dict(lse=lse, out_lo=lo[:, :1]), ValueError),
        "out_lo dtype": (dict(lse=lse, out_lo=lo.float()), TypeError),
        "missing lse": (dict(out_lo=lo), ValueError),
        "missing out_lo": (dict(lse=lse), ValueError),
    }


@pytest.mark.parametrize("what", list(_bad_stats(torch.zeros(1, 4, 8, 64))))
def test_the_wrapper_refuses_bad_statistics_before_any_launch(monkeypatch,
                                                              what):
    monkeypatch.setattr(fa, "on_cuda", lambda *t: True)
    monkeypatch.setattr(fa, "load_kernels", lambda: pytest.fail("launched"))
    q = torch.zeros((1, 4, 8, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    kw, err = _bad_stats(q)[what]
    with pytest.raises(err):
        fa.flash_attention_bwd(q, k, k, q, q, **kw)


def test_the_forward_refuses_statistics_its_kernel_does_not_store(
        monkeypatch):
    monkeypatch.setattr(fa, "on_cuda", lambda *t: True)
    monkeypatch.setattr(fa, "load_kernels", lambda: pytest.fail("launched"))
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 32)):
        q = torch.zeros((1, 4, 8, d), dtype=dtype)
        k = torch.zeros((1, 2, 8, d), dtype=dtype)
        with pytest.raises(ValueError, match="statistics"):
            fa.flash_attention(q, k, k, stats=True)


@pytest.mark.parametrize("dtype,d,want", [(torch.bfloat16, 64, True),
                                          (torch.bfloat16, 128, True),
                                          (torch.bfloat16, 32, False),
                                          (torch.float32, 64, False)])
def test_which_calls_run_from_the_statistics(dtype, d, want):
    assert fa.uses_stats(torch.zeros((1, 1, 1, d), dtype=dtype)) is want


@pytest.mark.parametrize("s,rows", [(1, 128), (128, 128), (129, 256),
                                    (4096, 4096), (4097, 4224)])
def test_lse_rows_round_up_to_the_kernels_tile(s, rows):
    assert fa.lse_rows(s) == rows


def test_the_forwards_lse_storage_goes_to_the_kernel_uncopied():
    b, hq, s = 2, 3, 130
    rows = torch.randn((b, hq, fa.lse_rows(s)))
    lse = rows[..., :s]
    got = fa._stats_rows(lse)
    assert got.data_ptr() == rows.data_ptr() and torch.equal(got, rows)
    # one batch element of it, as a hold of each element alone slices it
    one = fa._stats_rows(lse[1:2])
    assert one.data_ptr() == rows[1:2].data_ptr()
    # any other layout is copied into zero-padded rows
    dense = lse.contiguous()
    got = fa._stats_rows(dense)
    assert got.shape == rows.shape and got.data_ptr() != dense.data_ptr()
    assert torch.equal(got[..., :s], lse) and not bool(got[..., s:].any())


@pytest.mark.parametrize("dtype,d,stats", [(torch.bfloat16, 64, True),
                                           (torch.float32, 64, False),
                                           (torch.bfloat16, 16, False)])
def test_the_function_hands_the_forwards_statistics_to_the_backward(
        monkeypatch, dtype, d, stats):
    """With its tensors taken for CUDA tensors, ``ops.attention`` asks the
    forward for its statistics exactly where the backward runs from them,
    saves them, and passes the forward's own tensors to the backward; the
    gradients are the plain ones."""
    seen = {}

    def fwd(q, k, v, *, causal, stats=False):
        seen["stats"] = stats
        res = fa.flash_attention_plain(q, k, v, causal=causal, stats=stats)
        if stats:
            seen["lse"], seen["out_lo"] = res[1], res[2]
        return res

    def bwd(q, k, v, out, dout, *, lse=None, out_lo=None, causal=True):
        seen["bwd"] = (lse, out_lo)
        return fa.flash_attention_bwd_plain(q, k, v, dout, causal=causal)

    monkeypatch.setattr(fa, "flash_attention", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, h, 40, d), generator=gen).to(dtype)
               .requires_grad_(True) for h in (8, 2, 2))
    # ``uses_stats`` is the card's rule; the CPU plain forward follows it
    out = ops.attention(q, k, v, causal=True)
    dout = torch.randn(out.shape, generator=gen).to(dtype)
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert seen["stats"] is stats
    if stats:
        assert seen["bwd"][0] is seen["lse"]
        assert seen["bwd"][1] is seen["out_lo"]
    else:
        assert seen["bwd"] == (None, None)
    want = fa.flash_attention_bwd_plain(q, k, v, dout)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # serving: no gradient, no statistics
    seen.clear()
    with torch.no_grad():
        ops.attention(q, k, v, causal=True)
    assert seen["stats"] is False
