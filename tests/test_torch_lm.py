"""The port's LM serving path against the JAX reference, on the same inputs
(numpy, seeded) and the same weights (carried across with
``lm_params_from_jax``).

Tolerances: the attention entry point as the reference's own kernel test
holds it (``tests/test_kernels.py``: 2e-5 in f32, 2e-2 in bf16); the layers
at 1e-5 of the largest magnitude in f32 (the two frameworks sum in other
orders); whole models in f32 at 1e-4 of the largest logit (two layers of
such sums, plus a tied unembedding over the vocabulary) with equal greedy
tokens, and in bf16 at 2e-2 in relative norm (bf16 rounds at other places
in the two frameworks)."""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_kernels  # noqa: E402
from repro.models import decode_step as ref_decode_step  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import prefill as ref_prefill  # noqa: E402

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (decode_step, init_cache, init_params,  # noqa: E402
                                prefill)
from repro_torch.models import layers  # noqa: E402

#: the archs the port serves: every one
PORTED = ["llama3.2-1b", "qwen3-1.7b", "codeqwen1.5-7b", "starcoder2-7b",
          "qwen2-vl-2b", "musicgen-large", "jamba-v0.1-52b",
          "phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b", "xlstm-125m"]
#: the archs with Mamba, xLSTM or MoE layers, whose training came last
MIXER_ARCHS = ["jamba-v0.1-52b", "phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b",
            "xlstm-125m"]


def _t(x) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor of the same dtype (bf16 via
    float32, which holds it exactly)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().astype(np.float64)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"max abs err {err:.3e}, scale {scale:.3e}"


# -- (a) the attention entry point ---------------------------------------------

@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 2, 2, 32, 16), (2, 4, 2, 64, 32), (1, 8, 1, 96, 64), (2, 2, 2, 33, 32),
    # rep 1 and rep 4 at D = 64, the Hopper kernel's head dim on the card
    (1, 4, 4, 80, 64), (2, 8, 2, 72, 64),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_the_pallas_kernel(b, hq, hkv, s, d, causal, dtype):
    rng = np.random.default_rng(b * 1000 + hq * 100 + s)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v = (jnp.asarray(rng.standard_normal(shape), jdt)
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    want = ref_ops.attention(q, k, v, causal=causal, block_q=32, block_kv=32)
    got = ops.attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.dtype == _t(want).dtype and got.shape == (b, hq, s, d)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_masks_like_the_oracle(causal):
    """Sq != Skv, a kv_len mask and grouped heads against ``attention_ref``
    on the repeated heads (the Pallas kernel's function, f32)."""
    rng = np.random.default_rng(5)
    b, hq, hkv, sq, skv, d = 2, 6, 2, 37, 53, 32
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    rep = hq // hkv
    kk = np.repeat(k, rep, axis=1).reshape(b * hq, skv, d)
    vv = np.repeat(v, rep, axis=1).reshape(b * hq, skv, d)
    want = ref_kernels.attention_ref(q.reshape(b * hq, sq, d), kk, vv,
                                     causal=causal, kv_len=41)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, kv_len=41)
    _close(_np(got), np.asarray(want).reshape(b, hq, sq, d), 2e-5)


def _layouts(dtype):
    """(B, H, S, D) operands in the layouts the wrapper meets: a contiguous
    tensor, the model's head-transposed view, a view one element into its
    storage, and rows padded to a stride that is not a multiple of 8."""
    b, h, s, d = 2, 4, 5, 64
    flat = torch.zeros(b * h * s * d + 1, dtype=dtype)
    return {
        "contiguous": torch.zeros((b, h, s, d), dtype=dtype),
        "head_transposed": torch.zeros((b, s, h, d), dtype=dtype
                                       ).transpose(1, 2),
        "odd_offset": flat[1:].view(b, h, s, d),
        "stride_not_8": torch.zeros((b, h, s, d + 1), dtype=dtype)[..., :d],
    }


@pytest.mark.parametrize("layout,refused", [
    ("contiguous", None), ("head_transposed", None),
    ("odd_offset", "16-byte boundary"), ("stride_not_8", "multiple of 16")])
def test_operand_error_takes_what_tma_takes(layout, refused):
    """The rule for what the CUDA kernels read in place (TMA's: 16-byte
    strides and storage, unit stride along D), held on CPU tensors."""
    from repro_torch.kernels.flash_attention import operand_error
    t = _layouts(torch.bfloat16)[layout]
    err = operand_error(t)
    if refused is None:
        assert err is None
    else:
        assert refused in err
    # a dim of extent 1 never moves, so its stride does not count
    assert operand_error(t[:1]) == (None if refused is None else err)
    assert "along D" in operand_error(t.transpose(2, 3))


def test_flash_attention_refuses_a_layout_before_any_launch(monkeypatch):
    """On the card the wrapper raises on an operand the kernels cannot read
    in place, before it builds or launches anything."""
    import importlib
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    monkeypatch.setattr(fa, "on_cuda", lambda *t: True)
    monkeypatch.setattr(fa, "load_kernels", lambda: pytest.fail("launched"))
    ok = _layouts(torch.bfloat16)["contiguous"]
    bad = _layouts(torch.bfloat16)["stride_not_8"]
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="k: sequence stride of 130 bytes"):
        fa.flash_attention(ok, bad, ok)
    assert fa.flash_attention.launches == before


def test_the_bf16_kernel_is_the_hopper_design():
    """bf16 at D = 64 and 128 dispatches to the Hopper kernel, whose loads go
    through TMA onto mbarriers and whose products are wgmma, with a producer
    and consumer warpgroups; the dispatcher has no other route for it."""
    from repro_torch.kernels import _build
    sm90 = (_build._CSRC / "flash_attention_sm90.cu").read_text()
    # its TMA, mbarrier and wgmma helpers live in the header it includes,
    # which the backward's Hopper kernels share
    assert '#include "flash_sm90.cuh"' in sm90
    sm90 += (_build._CSRC / "flash_sm90.cuh").read_text()
    for ptx in ("cp.async.bulk.tensor.4d", "mbarrier.try_wait.parity",
                "mbarrier.arrive.expect_tx", "wgmma.mma_async",
                "setmaxnreg.dec", "setmaxnreg.inc",
                "CU_TENSOR_MAP_SWIZZLE_128B", "__grid_constant__"):
        assert ptx in sm90, ptx
    dispatch = (_build._CSRC / "flash_attention.cu").read_text()
    assert ("if (bf16 && p.D >= 64) return launch_flash_wgmma(p, stream);"
            in dispatch)
    assert "flash_attention_sm90.cu" in _build.SOURCES


# -- (b) the layers at f32 -------------------------------------------------------

def test_rms_norm_and_rope_match_the_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    _close(_np(layers.rms_norm(_t(x), _t(w), 1e-6)),
           ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6), 1e-5)

    pos = rng.integers(0, 300, (2, 7))
    for theta in (1e4, 5e5, 1e6):
        want = ref_layers.rope_cos_sin(jnp.asarray(pos), 64, theta)
        got = layers.rope_cos_sin(_t(pos), 64, theta)
        for g, w_ in zip(got, want):
            _close(_np(g), w_, 1e-5)

    pos3 = rng.integers(0, 300, (3, 2, 7))
    want = ref_layers.mrope_cos_sin(jnp.asarray(pos3), 16, 1e6, (2, 3, 3))
    got = layers.mrope_cos_sin(_t(pos3), 16, 1e6, (2, 3, 3))
    for g, w_ in zip(got, want):
        _close(_np(g), w_, 1e-5)

    xr = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    cos, sin = ref_layers.mrope_cos_sin(jnp.asarray(pos3), 16, 1e6, (2, 3, 3))
    _close(_np(layers.apply_rope(_t(xr), _t(cos), _t(sin))),
           ref_layers.apply_rope(jnp.asarray(xr), cos, sin), 1e-5)


def _qkv(rng, b, hq, hkv, s, t, d):
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in
                 ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d)))


@pytest.mark.parametrize("causal,s,kv_valid_len", [
    (False, 1, 9), (True, 5, None), (True, 6, 11)])
def test_plain_attention_matches_the_reference(causal, s, kv_valid_len):
    rng = np.random.default_rng(s)
    q, k, v = _qkv(rng, 2, 3, 3, s, 14, 16)
    want = ref_layers._plain_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal, kv_valid_len)
    got = layers._plain_attention(_t(q), _t(k), _t(v), causal, kv_valid_len)
    _close(_np(got), want, 1e-5)


@pytest.mark.parametrize("causal,s,t,kv_valid_len", [
    (True, 50, 50, None), (False, 40, 70, None), (True, 23, 61, None),
    (False, 33, 50, 29)])
def test_chunked_attention_matches_the_reference(causal, s, t, kv_valid_len):
    rng = np.random.default_rng(t)
    q, k, v = _qkv(rng, 2, 2, 2, s, t, 16)
    kw = dict(causal=causal, q_chunk=16, kv_chunk=16,
              kv_valid_len=kv_valid_len)
    want = ref_layers.flash_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), **kw)
    got = layers.flash_attention_xla(_t(q), _t(k), _t(v), **kw)
    _close(_np(got), want, 1e-5)


@pytest.mark.parametrize("impl,s", [("plain", 24), ("chunked", 40),
                                    ("auto", 24)])
def test_gqa_attention_matches_the_reference(impl, s):
    rng = np.random.default_rng(s)
    q, k, v = _qkv(rng, 2, 6, 2, s, s, 16)
    kw = dict(causal=True, q_chunk=16, kv_chunk=16, impl=impl)
    want = ref_layers.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **kw)
    got = layers.gqa_attention(_t(q), _t(k), _t(v), **kw)
    _close(_np(got), want, 1e-5)


def test_attn_apply_matches_the_reference():
    """One attention layer (qk_norm, GQA) without a cache and on a cache: a
    prefill of 6 at position 0, then one decode step at 6, f32."""
    from repro.models.transformer import _attn_apply as ref_attn_apply

    from repro_torch.models.transformer import _attn_apply

    rcfg = dataclasses.replace(ref_smoke_config("qwen3-1.7b"),
                               dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"), dtype="float32")
    rparams = ref_init_params(rcfg, jax.random.PRNGKey(2))
    slot = jax.tree_util.tree_map(lambda t: t[0], rparams["groups"]["s0"])
    layer = lm_params_from_jax(cfg, jax.tree_util.tree_map(
        np.asarray, rparams), "cpu")["layers"][0]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    cos, sin = ref_layers.rope_cos_sin(jnp.arange(6)[None].repeat(2, 0),
                                       cfg.head_dim_, cfg.rope_theta)
    want, _ = ref_attn_apply(slot, jnp.asarray(x), cos, sin, rcfg)
    got, _ = _attn_apply(layer, _t(x), _t(cos), _t(sin), cfg)
    _close(_np(got), want, 1e-5)

    shape = (2, cfg.num_kv_heads, 10, cfg.head_dim_)
    rcache = dict(k=jnp.zeros(shape), v=jnp.zeros(shape))
    cache = dict(k=torch.zeros(shape), v=torch.zeros(shape))
    want, rcache = ref_attn_apply(slot, jnp.asarray(x), cos, sin, rcfg,
                                  cache=rcache, pos=0)
    got, cache = _attn_apply(layer, _t(x), _t(cos), _t(sin), cfg,
                             cache=cache, pos=0)
    _close(_np(got), want, 1e-5)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    c1, s1 = ref_layers.rope_cos_sin(jnp.full((2, 1), 6), cfg.head_dim_,
                                     cfg.rope_theta)
    want, rcache = ref_attn_apply(slot, jnp.asarray(x1), c1, s1, rcfg,
                                  cache=rcache, pos=6)
    got, cache = _attn_apply(layer, _t(x1), _t(c1), _t(s1), cfg,
                             cache=cache, pos=6)
    _close(_np(got), want, 1e-5)
    for key in ("k", "v"):
        _close(_np(cache[key]), rcache[key], 1e-5)


# -- (c) carrying parameters across ----------------------------------------------

#: depths of the converted models: two or more groups of each smoke
#: pattern (jamba-smoke's period is 4, xlstm-smoke's 2)
CONVERT_LAYERS = {"jamba-v0.1-52b": 8, "xlstm-125m": 4}


@pytest.mark.parametrize("name", ["qwen3-1.7b", "musicgen-large",
                                  "jamba-v0.1-52b", "xlstm-125m"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lm_params_from_jax_is_bit_exact(name, dtype):
    """Every leaf of every slot (attention, dense and MoE MLPs, Mamba,
    mLSTM, sLSTM) crosses bit for bit, layer g · period + j from group g's
    slot j."""
    n = CONVERT_LAYERS.get(name, 3)
    cfg = dataclasses.replace(ref_smoke_config(name), dtype=dtype,
                              num_layers=n)
    ref = ref_init_params(cfg, jax.random.PRNGKey(3))
    got = lm_params_from_jax(
        dataclasses.replace(get_smoke_config(name), dtype=dtype,
                            num_layers=n),
        jax.tree_util.tree_map(np.asarray, ref), device="cpu")
    assert len(got["layers"]) == n
    pairs = [(got[k], ref[k]) for k in ("embed", "final_norm", "lm_head")
             if k in ref]
    assert set(got) == set(k for k in ref if k != "groups") | {"layers"}
    period = cfg.pattern_period
    for i, layer in enumerate(got["layers"]):
        flat = jax.tree_util.tree_leaves_with_path(
            ref["groups"][f"s{i % period}"])
        assert len(flat) == len(jax.tree_util.tree_leaves(layer))
        for path, leaf in flat:
            node = layer
            for key in path:
                node = node[key.key]
            pairs.append((node, leaf[i // period]))
    bits = {torch.bfloat16: (torch.int16, np.int16),
            torch.float32: (torch.int32, np.int32)}
    for t, a in pairs:
        tt, nt = bits[t.dtype]
        a = np.asarray(a)
        assert t.shape == a.shape
        assert np.array_equal(t.view(tt).numpy(), a.view(nt))


# -- (d), (e) prefill and decode against the reference ----------------------------

def _batches(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        x = rng.integers(0, cfg.vocab_size, (b, s))
        ref, port = {"tokens": jnp.asarray(x, jnp.int32)}, {"tokens": _t(x)}
    else:
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        ref, port = {"embeds": jnp.asarray(x)}, {"embeds": _t(x)}
    if cfg.mrope:
        p3 = np.stack([np.arange(s), np.arange(s) // 2, np.arange(s) % 5])
        p3 = np.broadcast_to(p3[:, None], (3, b, s))
        ref["positions3"], port["positions3"] = jnp.asarray(p3), _t(p3)
    return ref, port


def _unfused(fn):
    """``fn`` run op by op (``jax.disable_jit``), each bf16 result rounded
    where the reference's code rounds it: under ``jit`` XLA may keep fused
    bf16 elementwise work in float32 (excess precision)."""
    def run(*args):
        with jax.disable_jit():
            return fn(*args)
    return run


def _serve_both(name, dtype, b=2, s=16, steps=4, seed=0, unfused=False):
    """Prefill, then ``steps`` greedy decode steps in both packages, the
    port fed the reference's tokens; returns the logits of every call. The
    reference runs under ``jit``, or op by op with ``unfused``."""
    rcfg = dataclasses.replace(ref_smoke_config(name), dtype=dtype)
    cfg = dataclasses.replace(get_smoke_config(name), dtype=dtype)
    rparams = ref_init_params(rcfg, jax.random.PRNGKey(seed))
    params = lm_params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                            rparams), "cpu")
    rbatch, batch = _batches(cfg, b, s, seed)
    run = _unfused if unfused else jax.jit
    pf = run(lambda p, x: ref_prefill(rcfg, p, x, max_seq=s + steps))
    dc = run(lambda p, c, t: ref_decode_step(rcfg, p, c, t))
    rl, rc = pf(rparams, rbatch)
    logits, cache = prefill(cfg, params, batch, max_seq=s + steps)
    out = [(_np(logits), np.asarray(rl, np.float64))]
    tokens = []
    for _ in range(steps):
        if cfg.input_mode == "tokens":
            rtok = jnp.argmax(rl, -1)[:, None].astype(jnp.int32)
            tokens.append((_np(logits.argmax(-1)), np.asarray(rtok[:, 0])))
            tok = _t(rtok).long()
        else:
            rtok = jnp.zeros((b, 1, cfg.d_model), jnp.float32)
            tok = torch.zeros((b, 1, cfg.d_model))
        rl, rc = dc(rparams, rc, rtok)
        logits, cache = decode_step(cfg, params, cache, tok)
        out.append((_np(logits), np.asarray(rl, np.float64)))
    assert cache["pos"] == s + steps == int(rc["pos"])
    return out, tokens


@pytest.mark.parametrize("name", PORTED)
def test_serving_matches_the_reference_f32(name):
    out, tokens = _serve_both(name, "float32")
    for got, want in out:
        _close(got, want, 1e-4)
    for got, want in tokens:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", PORTED)
def test_serving_matches_the_reference_bf16(name):
    """bf16 at 2e-2 in relative norm. A model with MoE MLPs is held
    against the reference run op by op: its top-k routing is
    discontinuous, and a gate within a bf16 rounding of the next one
    (gaps of ~6e-5 at these smoke sizes) picks other experts when XLA's
    fusions skip a rounding, which moves a token's logits by far more than
    any tolerance (phi3.5-moe-smoke: 0.47 against the jitted reference);
    op by op, the reference rounds where the port does."""
    unfused = get_smoke_config(name).num_experts > 0
    out, _ = _serve_both(name, "bfloat16", unfused=unfused)
    for got, want in out:
        assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)


@pytest.mark.parametrize("b,s", [(2, 256), (2, 1)])
def test_jamba_serving_matches_the_reference_at_more_shapes(b, s,
                                                            monkeypatch):
    """jamba-smoke at B 2 × S 256, whose 512 prompt tokens take the MoE
    capacity branch in both packages, and at a prompt of length 1, where
    each mixer takes its decode step from the cache inside the prefill
    (and the MoE its dense branch); f32."""
    from repro.models import moe as ref_moe
    from repro_torch.models import moe

    calls = {"ref": 0, "port": 0}

    def spy(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ref_moe, "_local_moe", spy(ref_moe._local_moe,
                                                   "ref"))
    monkeypatch.setattr(moe, "_local_moe", spy(moe._local_moe, "port"))
    out, tokens = _serve_both("jamba-v0.1-52b", "float32", b=b, s=s,
                              steps=2)
    cfg = get_smoke_config("jamba-v0.1-52b")
    n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
    want = n_moe if b * s >= moe.DENSE_TOKENS else 0
    assert calls["port"] == want and (calls["ref"] > 0) == (want > 0)
    for got, want in out:
        _close(got, want, 1e-4)
    for got, want in tokens:
        assert np.array_equal(got, want)


def test_long_prompt_takes_the_chunked_branch_in_both(monkeypatch):
    """A prompt of 2,056 (> 2,048) runs the chunked attention in both
    packages: the reference's XLA twin, the port's plain twin on the CPU."""
    calls = {"ref": 0, "port": 0}

    def spy(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ref_layers, "flash_attention_xla",
                        spy(ref_layers.flash_attention_xla, "ref"))
    monkeypatch.setattr(layers, "flash_attention_xla",
                        spy(layers.flash_attention_xla, "port"))
    out, tokens = _serve_both("qwen3-1.7b", "float32", b=1, s=2056, steps=1)
    assert calls["port"] == get_smoke_config("qwen3-1.7b").num_layers
    assert calls["ref"] >= 1
    for got, want in out:
        _close(got, want, 1e-4)
    for got, want in tokens:
        assert np.array_equal(got, want)


def test_chunked_branch_off_the_cpu_calls_only_the_kernel_entry(monkeypatch):
    """With its tensors taken for CUDA tensors, every layer of a long
    prefill calls ``ops.attention`` (the kernel's entry) and never the plain
    twin: the model's public entry has no route to a plain version on the
    card."""
    calls = {"kernel": 0, "twin": 0}

    def kernel(q, k, v, *, causal=True):
        calls["kernel"] += 1
        return flash_attention(q, k, v, causal=causal)

    def twin(*a, **kw):
        calls["twin"] += 1
        return layers.flash_attention_xla(*a, **kw)

    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    batch = serve.make_batch(cfg, 1, 2049, "cpu")
    monkeypatch.setattr(layers, "on_cuda", lambda *t: True)
    monkeypatch.setattr(layers.ops, "attention", kernel)
    monkeypatch.setattr(layers, "flash_attention_xla", twin)
    logits, _ = prefill(cfg, params, batch, 2050)
    assert calls == {"kernel": cfg.num_layers, "twin": 0}
    assert bool(torch.isfinite(logits).all())


def test_decode_past_the_end_of_the_cache_raises():
    """A decode step with the cache full raises ``ValueError`` in the port.
    This is a deliberate divergence: the reference's
    ``dynamic_update_slice_in_dim`` clamps the start instead and silently
    overwrites the last slot (``src/repro/models/transformer.py:180-183``)."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    batch = serve.make_batch(cfg, 2, 6, "cpu")
    logits, cache = prefill(cfg, params, batch, max_seq=7)
    tok = logits.argmax(-1)[:, None]
    logits, cache = decode_step(cfg, params, cache, tok)  # fills slot 6
    assert cache["pos"] == 7 and bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="the cache holds 7 positions"):
        decode_step(cfg, params, cache, logits.argmax(-1)[:, None])


# -- (f) what is not ported, and the launcher --------------------------------------

def test_every_arch_resolves_and_the_unported_ones_raise():
    """Every arch builds and serves, and the ones with Mamba, xLSTM or MoE
    layers (whose training the port once refused) train: ``loss_fn`` gives
    a finite loss, ``ce + 0.01·aux`` with a positive aux where there are
    experts, and a gradient on every leaf, and a ``Trainer`` takes a step
    and lowers the loss of its batch."""
    from repro_torch.models import loss_fn
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.transformer import MOE_AUX_COEF
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig

    assert sorted(ARCH_NAMES) == sorted(PORTED)
    gen = torch.Generator().manual_seed(0)
    for name in ARCH_NAMES:
        assert get_config(name).name == name
    for name in MIXER_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(name), dtype="float32")
        params = init_params(cfg, gen)
        assert len(init_cache(cfg, 1, 8, device="cpu")["layers"]) == \
            cfg.num_layers
        batch = serve.make_batch(cfg, 1, 8, "cpu")
        batch["labels"] = batch["tokens"]
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss, m = loss_fn(cfg, params, batch)
        loss.backward()
        assert bool(torch.isfinite(loss))
        assert float(loss) == pytest.approx(
            float(m["ce"]) + MOE_AUX_COEF * float(m["aux"]), rel=1e-6)
        assert (float(m["aux"]) > 0.0) == bool(cfg.num_experts)
        assert all(p.grad is not None for p in tree_leaves(params))
        with tempfile.TemporaryDirectory() as d:
            t = Trainer(cfg, ShapeSpec("t", 8, 2, "train"), TrainerConfig(
                ckpt_dir=d, total_steps=4, warmup_steps=1), device="cpu")
            ps, opt = t.init_state()
            b0 = t.batch(0)
            ps, opt, m0 = t.step(ps, opt, b0, 1)
            m1, _ = t.gradients(ps, b0)
            assert float(m1["loss"]) < float(m0["loss"])


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "xlstm-125m"])
def test_init_params_of_the_mixers_follow_the_reference(name):
    """At full width, every leaf's shape and dtype equal the reference's
    (the meta tree against ``jax.eval_shape``); on the smoke config, the
    leaves the reference draws at random have its spread (within 20 % of
    its standard deviation, zero mean) and the others its values (within
    1e-6)."""
    from repro.configs import get_config as ref_config

    rcfg = ref_config(name)
    ref = jax.eval_shape(lambda: ref_init_params(rcfg, jax.random.PRNGKey(0)))
    got = init_params(get_config(name), None)
    for i, layer in enumerate(got["layers"]):
        slot = ref["groups"][f"s{i % rcfg.pattern_period}"]
        flat = jax.tree_util.tree_leaves_with_path(slot)
        assert len(flat) == len(jax.tree_util.tree_leaves(layer))
        for path, leaf in flat:
            node = layer
            for key in path:
                node = node[key.key]
            assert node.shape == leaf.shape[1:], path
            assert str(node.dtype).split(".")[1] == str(leaf.dtype), path

    rs = ref_smoke_config(name)
    r0, r1 = (ref_init_params(rs, jax.random.PRNGKey(k)) for k in (0, 1))
    got = init_params(get_smoke_config(name),
                      torch.Generator().manual_seed(0))
    kinds = set()
    for i, layer in enumerate(got["layers"]):
        j = f"s{i % rs.pattern_period}"
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(
                r0["groups"][j]), jax.tree_util.tree_leaves(r1["groups"][j])):
            node = layer
            for key in path:
                node = node[key.key]
            a = np.asarray(a[i // rs.pattern_period], np.float64)
            b = np.asarray(b[i // rs.pattern_period], np.float64)
            kinds.add(path[0].key)
            if np.array_equal(a, b):
                # a constant (a_log's logarithms: XLA's float32 log is
                # within an ulp of the correctly rounded one)
                np.testing.assert_allclose(_np(node), a, rtol=1e-6,
                                           err_msg=str(path))
                continue
            assert abs(float(_np(node).std()) / a.std() - 1) < 0.2, path
            assert abs(float(_np(node).mean())) < 0.2 * a.std(), path
    want = {"jamba-v0.1-52b": {"norm1", "attn", "mamba", "norm2", "mlp"},
            "xlstm-125m": {"norm1", "mlstm", "slstm"}}[name]
    assert kinds == want


def test_init_params_follows_the_reference_shapes_and_scales():
    cfg = get_smoke_config("starcoder2-7b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    ref = ref_init_params(ref_smoke_config("starcoder2-7b"),
                          jax.random.PRNGKey(0))
    assert params["lm_head"].shape == ref["lm_head"].shape
    layer, slot = params["layers"][1], ref["groups"]["s0"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(slot):
        node = layer
        for key in path:
            node = node[key.key]
        assert node.shape == leaf.shape[1:] and node.dtype == torch.bfloat16
    wi = layer["mlp"]["wi"].float()
    assert abs(float(wi.std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert abs(float(params["embed"].float().std()) / 0.02 - 1) < 0.05


def test_serve_launcher_runs_on_the_cpu(capsys):
    out = serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "12", "--decode-steps", "3"])
    assert out["tokens"].shape == (2, 3)
    assert torch.isfinite(out["logits"]).all()
    assert "[serve] qwen3-smoke" in capsys.readouterr().out
    out = serve.main(["--arch", "jamba-v0.1-52b", "--smoke", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "12",
                      "--decode-steps", "3"])
    assert out["tokens"].shape == (2, 3)
    assert torch.isfinite(out["logits"]).all()
    assert "[serve] jamba-smoke" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:  # a split that is not --devices
        serve.main(["--smoke", "--device", "cpu", "--devices", "2",
                    "--model-par", "3"])
    assert e.value.code == 2
    assert "data_par × model_par must = devices" in capsys.readouterr().err
