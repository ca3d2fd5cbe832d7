"""The port's MoE, Mamba and xLSTM mixers against the JAX reference's, on
the same seeded inputs and the same weights (the reference's, carried
across as numpy arrays).

Tolerances: float32 at 1e-5 of the largest magnitude (the two frameworks
sum in other orders, and the Mamba scan combines in another tree); bf16 at
2e-2 in relative norm (bf16 rounds at other places in the two
frameworks), with the routing itself (the top-k experts, float32 gates of
the same bf16 input) required equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models import xlstm as ref_xlstm  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe, ssm, xlstm  # noqa: E402

F32_RTOL, BF16_RNORM = 1e-5, 2e-2


def _t(x) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor of the same dtype (bf16 via
    float32, which holds it exactly)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _tree(tree):
    return {k: _tree(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().astype(np.float64)


def _close(got, want, dtype="float32"):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if dtype == "bfloat16":
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= BF16_RNORM, f"‖Δ‖/‖ref‖ {rel:.3e}"
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= F32_RTOL * scale, f"max abs err {err:.3e}, scale {scale:.3e}"


def _jit(fn, *static):
    """The reference function under ``jax.jit`` (one compile per shape is
    far quicker than its eager op-by-op dispatch)."""
    return jax.jit(fn, static_argnames=("cfg",) + static)


def _cfgs(name, dtype, **kw):
    return (dataclasses.replace(ref_smoke_config(name), dtype=dtype, **kw),
            dataclasses.replace(get_smoke_config(name), dtype=dtype, **kw))


def _x(shape, seed, dtype, offset=0.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) + offset).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return jnp.asarray(x, jdt)


MAMBA = _jit(ref_ssm.mamba_forward, "chunk", "return_state")
MLSTM = _jit(ref_xlstm.mlstm_forward, "chunk", "return_state")
SLSTM = _jit(ref_xlstm.slstm_forward, "return_state")
MOE = _jit(ref_moe.moe_ffn)
STEPS = {"m": _jit(ref_ssm.mamba_decode_step),
         "M": _jit(ref_xlstm.mlstm_decode_step),
         "s": _jit(ref_xlstm.slstm_decode_step)}


# -- MoE -------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("branch,b,s,k", [
    ("dense", 2, 16, 2), ("dense", 1, 1, 3),
    ("capacity", 2, 256, 2), ("capacity", 4, 160, 3)])
def test_moe_ffn_matches_the_reference(branch, b, s, k, dtype):
    """Both branches of the rule (< 512 tokens: every expert densely; else
    the capacity buffers), with k = 2 and 3 (slots combined in order)."""
    rcfg, cfg = _cfgs("moonshot-v1-16b-a3b", dtype, experts_per_token=k)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    rp = ref_moe.init_moe_params(jax.random.PRNGKey(b + s + k), rcfg, jdt)
    x = _x((b, s, cfg.d_model), s, dtype)
    want, want_aux = MOE(rp, x, cfg=rcfg)
    got, aux = moe.moe_ffn(_tree(rp), _t(x), cfg)
    assert (b * s < moe.DENSE_TOKENS) == (branch == "dense")
    assert got.dtype == _t(want).dtype and aux.dtype == torch.float32
    _close(_np(got), want, dtype)
    _close(float(aux), float(want_aux))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_capacity_drops_the_overflow_like_the_reference(dtype):
    """Tokens that share a direction all route to the same experts, so
    some expert's buffer overflows: the slots past its capacity add
    nothing, in both packages."""
    rcfg, cfg = _cfgs("phi3.5-moe-42b-a6.6b", dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    rp = ref_moe.init_moe_params(jax.random.PRNGKey(7), rcfg, jdt)
    b, s, k, e = 2, 256, cfg.experts_per_token, cfg.num_experts
    x = _x((b, s, cfg.d_model), 1, dtype, offset=1.0)
    gates = np.asarray(jax.nn.softmax(
        x.reshape(-1, cfg.d_model).astype(jnp.float32) @ rp["router"]))
    load = np.bincount(np.argsort(-gates, axis=-1)[:, :k].ravel(),
                       minlength=e)
    cap = int(1.25 * b * s * k / e) + 1
    assert load.max() > cap, (load, cap)
    want, want_aux = MOE(rp, x, cfg=rcfg)
    got, aux = moe.moe_ffn(_tree(rp), _t(x), cfg)
    _close(_np(got), want, dtype)
    _close(float(aux), float(want_aux))
    # the last token's slots are past the overflowing expert's capacity
    dense, _ = moe._dense_all_experts(
        _t(x).reshape(-1, cfg.d_model), *(_t(rp[n]) for n in
                                          ("router", "wg", "wu", "wd")),
        k=k, num_experts=e)
    assert not torch.allclose(got.reshape(-1, cfg.d_model)[-1], dense[-1])


# -- Mamba -----------------------------------------------------------------------

def _mamba(seed):
    rcfg, cfg = _cfgs("jamba-v0.1-52b", "float32")
    rp = ref_ssm.init_mamba_params(jax.random.PRNGKey(seed), rcfg,
                                   jnp.float32)
    # a dt that moves the state: the init's dt ≈ 0.01 barely decays it
    rp["dt_bias"] = rp["dt_bias"] + 3.0
    return rcfg, cfg, rp, _tree(rp)


@pytest.mark.parametrize("s,chunk", [(21, 8), (2, 8)])
def test_mamba_forward_and_state_match_the_reference(s, chunk):
    """S not a multiple of the chunk (time padded with dt = 0), and S
    shorter than the conv window (the state's window padded)."""
    rcfg, cfg, rp, p = _mamba(s)
    x = _x((2, s, cfg.d_model), s, "float32")
    want, wst = MAMBA(rp, x, cfg=rcfg, chunk=chunk, return_state=True)
    _close(_np(ssm.mamba_forward(p, _t(x), cfg, chunk=chunk)), want)
    got, st = ssm.mamba_forward(p, _t(x), cfg, chunk=chunk,
                                return_state=True)
    _close(_np(got), want)
    assert set(st) == set(wst)
    for key in st:
        assert st[key].dtype == _t(wst[key]).dtype
        _close(_np(st[key]), wst[key])


def test_mamba_decode_continues_the_forward():
    """Two decode steps from the state of a 21-step forward (chunks of 8,
    the last one padded) against the reference's steps and against the
    port's forward over 23 steps at its last two positions."""
    rcfg, cfg, rp, p = _mamba(21)
    x = _x((2, 23, cfg.d_model), 5, "float32")
    full = _np(ssm.mamba_forward(p, _t(x), cfg, chunk=8))
    want, wst = MAMBA(rp, x[:, :21], cfg=rcfg, chunk=8, return_state=True)
    got, st = ssm.mamba_forward(p, _t(x[:, :21]), cfg, chunk=8,
                                return_state=True)
    _close(_np(got), want)
    _close(full[:, :21], want)
    for t in (21, 22):
        want, wst = STEPS["m"](rp, wst, x[:, t:t + 1], cfg=rcfg)
        got, st = ssm.mamba_decode_step(p, st, _t(x[:, t:t + 1]), cfg)
        _close(_np(got), want)
        _close(_np(got), full[:, t:t + 1])
        for key in st:
            _close(_np(st[key]), wst[key])
    init = ssm.init_mamba_state(cfg, 2, torch.float32, "cpu")
    ref_init = ref_ssm.init_mamba_state(rcfg, 2, jnp.float32)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: v.shape for k, v in ref_init.items()}


# -- xLSTM -----------------------------------------------------------------------

def _xl(kind, seed):
    rcfg, cfg = _cfgs("xlstm-125m", "float32")
    init = (ref_xlstm.init_mlstm_params if kind == "M"
            else ref_xlstm.init_slstm_params)
    rp = init(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    return rcfg, cfg, rp, _tree(rp)


@pytest.mark.parametrize("s,chunk", [(21, 8), (2, 8)])
def test_mlstm_forward_state_and_decode_match_the_reference(s, chunk):
    """The chunked forward and its state against the reference's; two
    decode steps from that state against the reference's steps and the
    port's forward over two more positions."""
    rcfg, cfg, rp, p = _xl("M", s)
    x = _x((2, s + 2, cfg.d_model), s, "float32")
    full = _np(xlstm.mlstm_forward(p, _t(x), cfg, chunk=chunk))
    want, wst = MLSTM(rp, x[:, :s], cfg=rcfg, chunk=chunk, return_state=True)
    _close(_np(xlstm.mlstm_forward(p, _t(x[:, :s]), cfg, chunk=chunk)),
           want)
    got, st = xlstm.mlstm_forward(p, _t(x[:, :s]), cfg, chunk=chunk,
                                  return_state=True)
    _close(_np(got), want)
    assert set(st) == set(wst)
    for key in st:
        assert st[key].dtype == torch.float32
        _close(_np(st[key]), wst[key])
    for t in (s, s + 1):
        want, wst = STEPS["M"](rp, wst, x[:, t:t + 1], cfg=rcfg)
        got, st = xlstm.mlstm_decode_step(p, st, _t(x[:, t:t + 1]), cfg)
        _close(_np(got), want)
        _close(_np(got), full[:, t:t + 1])
        for key in st:
            _close(_np(st[key]), wst[key])


def test_slstm_forward_state_and_decode_match_the_reference():
    rcfg, cfg, rp, p = _xl("s", 4)
    x = _x((2, 15, cfg.d_model), 4, "float32")
    full = _np(xlstm.slstm_forward(p, _t(x), cfg))
    want, wst = SLSTM(rp, x[:, :13], cfg=rcfg, return_state=True)
    _close(_np(xlstm.slstm_forward(p, _t(x[:, :13]), cfg)), want)
    got, st = xlstm.slstm_forward(p, _t(x[:, :13]), cfg, return_state=True)
    _close(_np(got), want)
    assert set(st) == set(wst)
    for key in st:
        _close(_np(st[key]), wst[key])
    for t in (13, 14):
        want, wst = STEPS["s"](rp, wst, x[:, t:t + 1], cfg=rcfg)
        got, st = xlstm.slstm_decode_step(p, st, _t(x[:, t:t + 1]), cfg)
        _close(_np(got), want)
        _close(_np(got), full[:, t:t + 1])
    # the initial state: m at -1e30, so the first step's forget term is 0
    init = xlstm.init_slstm_state(cfg, 2, "cpu")
    ref_init = ref_xlstm.init_slstm_state(rcfg, 2)
    for key in init:
        assert np.array_equal(_np(init[key]), np.asarray(ref_init[key]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_numerics_follow_the_reference(dtype):
    """The mLSTM's group norm (population variance) and the sLSTM's
    tanh-approximate GELU, in both dtypes, through one forward each."""
    rcfg, cfg = _cfgs("xlstm-125m", dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = _x((1, 9, cfg.d_model), 8, dtype)
    for init, fwd, pfwd in (
            (ref_xlstm.init_mlstm_params, MLSTM, xlstm.mlstm_forward),
            (ref_xlstm.init_slstm_params, SLSTM, xlstm.slstm_forward)):
        rp = init(jax.random.PRNGKey(9), rcfg, jdt)
        want = fwd(rp, x, cfg=rcfg)
        got = pfwd(_tree(rp), _t(x), cfg)
        assert got.dtype == _t(want).dtype
        _close(_np(got), want, dtype)
