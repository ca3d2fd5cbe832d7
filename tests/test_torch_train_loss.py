"""The port's training forward and loss against the JAX reference: the loss
and every parameter's gradient of ``loss_fn`` from the same weights
(carried across with ``lm_params_from_jax``) on the same seeded batch,
against ``jax.value_and_grad`` of the reference's ``loss_fn``.

Tolerances: in f32 the loss within 1e-5 relative and each gradient leaf
within 1e-4 of its largest magnitude (the two frameworks sum in other
orders, through two layers and an unembedding over the vocabulary); in
bf16 the loss within 1e-2 relative and each gradient leaf within 5e-2 in
relative norm, since bf16 rounds at other places in the two frameworks
(the activations, and gradients summed in bf16 where a token repeats)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models import loss_fn as ref_loss_fn  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import loss_fn, transformer  # noqa: E402
from repro_torch.train.optimizer import tree_leaves, tree_map  # noqa: E402

#: the smoke configs of five families: llama (tied embeddings), qwen3
#: (qk-norm), starcoder2 (GELU MLP), musicgen (embeddings in), qwen2-vl
#: (M-RoPE)
ARCHS = ["llama3.2-1b", "qwen3-1.7b", "starcoder2-7b", "musicgen-large",
         "qwen2-vl-2b"]


def _t(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _batch(cfg, b, s, seed):
    """The same seeded batch for both packages: tokens or embeddings,
    labels, and M-RoPE positions for qwen2-vl."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        x = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)
                                    ).astype(np.int32)}
    else:
        x = {"embeds": rng.standard_normal((b, s, cfg.d_model)
                                           ).astype(np.float32)}
    x["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.mrope:
        p3 = np.stack([np.arange(s), np.arange(s) // 2, np.arange(s) % 5])
        x["positions3"] = np.broadcast_to(p3[:, None], (3, b, s)
                                          ).astype(np.int32)
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: _t(v) for k, v in x.items()})


def _loss_and_grads(name, dtype, b=2, s=16, seed=0, **over):
    """(port loss, reference loss, [(port grad, reference grad)] over every
    parameter leaf), the reference's gradients unstacked to the port's
    layout."""
    rcfg = dataclasses.replace(ref_smoke_config(name), dtype=dtype, **over)
    cfg = dataclasses.replace(get_smoke_config(name), dtype=dtype, **over)
    rparams = ref_init_params(rcfg, jax.random.PRNGKey(seed))
    params = lm_params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                            rparams), "cpu")
    rbatch, batch = _batch(cfg, b, s, seed)
    (rloss, rm), rgrads = jax.jit(jax.value_and_grad(
        lambda p, x: ref_loss_fn(rcfg, p, x), has_aux=True))(rparams, rbatch)
    tree_map(lambda p: p.requires_grad_(True), params)
    loss, m = loss_fn(cfg, params, batch)
    loss.backward()
    assert set(m) == {"ce", "aux"} and float(m["aux"]) == 0.0
    assert float(rm["aux"]) == 0.0
    want = lm_params_from_jax(cfg, jax.tree_util.tree_map(
        lambda g: np.asarray(g, np.float32), rgrads), "cpu")
    pairs = list(zip(tree_leaves(tree_map(lambda p: p.grad, params)),
                     tree_leaves(want)))
    assert len(pairs) == len(tree_leaves(params)) == sum(
        np.asarray(g).shape[0] if path[0].key == "groups" else 1
        for path, g in jax.tree_util.tree_leaves_with_path(rgrads))
    return float(loss), float(rloss), pairs


def _hold(loss, rloss, pairs, dtype):
    if dtype == "float32":
        assert abs(loss - rloss) <= 1e-5 * abs(rloss)
        for g, w in pairs:
            assert g.dtype == torch.float32
            g, w = g.double().numpy(), w.double().numpy()
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= 1e-4 * scale
    else:
        assert abs(loss - rloss) <= 1e-2 * abs(rloss)
        for g, w in pairs:
            assert g.dtype == torch.bfloat16
            g, w = g.double().numpy(), w.double().numpy()
            assert np.linalg.norm(g - w) <= 5e-2 * np.linalg.norm(w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_gradients_match_the_reference(name, dtype):
    loss, rloss, pairs = _loss_and_grads(name, dtype)
    _hold(loss, rloss, pairs, dtype)


def test_eight_chunk_cross_entropy_matches_the_reference():
    """S = 1,024: both packages take the cross entropy in 8 checkpointed
    chunks."""
    loss, rloss, pairs = _loss_and_grads("llama3.2-1b", "float32", b=1,
                                         s=1024, num_layers=1)
    _hold(loss, rloss, pairs, "float32")


def test_chunked_attention_branch_matches_the_reference(monkeypatch):
    """The chunked attention branch (the port's plain twin on the CPU, the
    reference's XLA twin), taken at S = 40 by asking for it, with chunks of
    16 so that each sequence spans three ragged chunks, differentiated in
    both packages."""
    calls = {"ref": 0, "port": 0}

    def chunked(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **{**kw, "impl": "chunked"})
        return wrapped

    monkeypatch.setattr(ref_transformer, "gqa_attention",
                        chunked(ref_transformer.gqa_attention, "ref"))
    monkeypatch.setattr(transformer, "gqa_attention",
                        chunked(transformer.gqa_attention, "port"))
    loss, rloss, pairs = _loss_and_grads("qwen3-1.7b", "float32", s=40,
                                         attn_q_chunk=16, attn_kv_chunk=16)
    assert calls["ref"] >= 1 and calls["port"] >= 2
    _hold(loss, rloss, pairs, "float32")


def test_remat_changes_nothing_but_the_memory():
    """``remat="none"`` and ``"layer"`` give the same loss and gradients:
    the checkpoint only recomputes."""
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              dtype="float32")
    _, batch = _batch(cfg, 2, 16, 1)
    out = []
    for remat in ("layer", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        params = transformer.init_params(c, torch.Generator().manual_seed(0))
        tree_map(lambda p: p.requires_grad_(True), params)
        loss, _ = loss_fn(c, params, batch)
        loss.backward()
        out.append([float(loss)] + [p.grad for p in tree_leaves(params)])
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1:], out[1][1:]):
        assert torch.equal(a, b)
