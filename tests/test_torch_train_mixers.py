"""Training the MoE, Mamba and xLSTM archs in the port against the JAX
reference: the loss and every parameter's gradient of ``loss_fn`` from the
same weights (carried across with ``lm_params_from_jax``) on the same
seeded batch, against ``jax.value_and_grad`` of the reference's
``loss_fn``; and the ``Trainer`` on jamba's smoke config, restarted
against an uninterrupted run.

The cases reach both MoE branches (below 512 tokens every expert densely,
else the capacity buffers), a capacity branch that drops slots (the
embeddings share a direction, so the routing crowds a few experts; the
drops are counted from each package's own MoE inputs), Mamba and mLSTM
chunks at a sequence that is not a multiple of the chunk (300 against
256), and an sLSTM of a few steps. ``jamba-cut`` is jamba cut to its
layers 4 and 5 (attention with a dense MLP, then Mamba with the MoE MLP),
the cut ``chip_smoke.py`` trains at full width, here at smoke width.

Tolerances are those of ``tests/test_torch_train_loss.py``: in f32 the
loss within 1e-5 relative and each gradient leaf within 1e-4 of its
largest magnitude; in bf16 the loss within 1e-2 relative and each leaf
within 5e-2 in relative norm. In bf16 a model with MoE MLPs is held
against the reference run op by op (``jax.disable_jit``): under ``jit``
XLA keeps fused bf16 work in float32, and top-k routing then flips on
gates a rounding apart."""
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
from repro_torch.models import loss_fn, moe, transformer  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.optimizer import tree_leaves, tree_map  # noqa: E402

ARCHS = {"jamba": "jamba-v0.1-52b", "phi": "phi3.5-moe-42b-a6.6b",
         "moonshot": "moonshot-v1-16b-a3b", "xlstm": "xlstm-125m"}
#: jamba's layers 4 and 5: 'a' with a dense MLP, then 'm' with the MoE
JAMBA_CUT = dict(num_layers=2, block_pattern=("a", "m"))


def _cfgs(arch, dtype, cut=False):
    over = dict(dtype=dtype, **(JAMBA_CUT if cut else {}))
    return (dataclasses.replace(ref_smoke_config(ARCHS[arch]), **over),
            dataclasses.replace(get_smoke_config(ARCHS[arch]), **over))


def _t(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    x = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: _t(v) for k, v in x.items()})


def _drops(h: np.ndarray, router: np.ndarray, cfg) -> int:
    """Slots past their expert's capacity for one MoE input (B, S, D), in
    numpy: the capacity path's routing."""
    k, e = cfg.experts_per_token, cfg.num_experts
    x = h.reshape(-1, h.shape[-1]).astype(np.float32)
    logits = x @ router.astype(np.float32)
    topi = np.argsort(-logits, axis=-1, kind="stable")[:, :k].reshape(-1)
    cap = int(1.25 * x.shape[0] * k / e) + 1
    seen = np.zeros(e, np.int64)
    dropped = 0
    for ex in topi:
        dropped += int(seen[ex] >= cap)
        seen[ex] += 1
    return dropped


def _loss_and_grads(arch, dtype, b, s, seed=0, cut=False, crowd=False,
                    monkeypatch=None):
    """(port loss, reference loss, port aux, reference aux, [(port grad,
    reference grad)] over every leaf, {package: dropped slots}). With
    ``crowd`` the embedding rows share a direction (+1 on every entry), in
    both packages, so that routing crowds a few experts."""
    rcfg, cfg = _cfgs(arch, dtype, cut)
    rparams = ref_init_params(rcfg, jax.random.PRNGKey(seed))
    if crowd:
        rparams = dict(rparams, embed=(rparams["embed"].astype(jnp.float32)
                                       + 1.0).astype(rparams["embed"].dtype))
    params = lm_params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                            rparams), "cpu")
    rbatch, batch = _batch(cfg, b, s, seed)
    drops = {"ref": [], "port": []}
    if crowd:
        def count(fn, key):
            def wrapped(p, h, c, *a, **kw):
                if key == "port":
                    drops[key].append(_drops(h.detach().float().numpy(),
                                             p["router"].detach().numpy(), c))
                else:
                    jax.debug.callback(lambda hh, rr: drops[key].append(
                        _drops(np.asarray(hh, np.float32), np.asarray(rr),
                               c)), h, p["router"])
                return fn(p, h, c, *a, **kw)
            return wrapped
        monkeypatch.setattr(ref_transformer, "moe_ffn",
                            count(ref_transformer.moe_ffn, "ref"))
        monkeypatch.setattr(transformer, "moe_ffn",
                            count(transformer.moe_ffn, "port"))
    vg = jax.value_and_grad(lambda p, x: ref_loss_fn(rcfg, p, x),
                            has_aux=True)
    if dtype == "bfloat16" and cfg.num_experts:
        with jax.disable_jit():
            (rloss, rm), rgrads = vg(rparams, rbatch)
    else:
        (rloss, rm), rgrads = jax.jit(vg)(rparams, rbatch)
    tree_map(lambda p: p.requires_grad_(True), params)
    loss, m = loss_fn(cfg, params, batch)
    loss.backward()
    assert set(m) == {"ce", "aux"} and m["aux"].dtype == torch.float32
    assert float(loss.detach()) == pytest.approx(
        float(m["ce"]) + transformer.MOE_AUX_COEF * float(m["aux"]),
        rel=1e-6)
    want = lm_params_from_jax(cfg, jax.tree_util.tree_map(
        lambda g: np.asarray(g, np.float32), rgrads), "cpu")
    pairs = list(zip(tree_leaves(tree_map(lambda p: p.grad, params)),
                     tree_leaves(want)))
    assert len(pairs) == len(tree_leaves(params))
    assert all(g is not None for g, _ in pairs)
    return (float(loss), float(rloss), float(m["aux"]), float(rm["aux"]),
            pairs, {k: sum(v) for k, v in drops.items()})


def _hold(loss, rloss, aux, raux, pairs, dtype):
    if dtype == "float32":
        assert abs(loss - rloss) <= 1e-5 * abs(rloss), (loss, rloss)
        assert abs(aux - raux) <= 1e-5 * max(abs(raux), 1e-30), (aux, raux)
        for g, w in pairs:
            assert g.dtype == torch.float32
            g, w = g.double().numpy(), w.double().numpy()
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= 1e-4 * scale
    else:
        assert abs(loss - rloss) <= 1e-2 * abs(rloss), (loss, rloss)
        for g, w in pairs:
            assert g.dtype in (torch.bfloat16, torch.float32)
            g, w = g.double().numpy(), w.double().numpy()
            assert np.linalg.norm(g - w) <= 5e-2 * max(np.linalg.norm(w),
                                                       1e-30)


#: (arch, B, S, jamba cut, crowded routing): what each case reaches
F32_CASES = {
    # 'm','a','m','m' with MoE on slots 1 and 3, 32 tokens: the dense branch
    "jamba-dense": ("jamba", 2, 16, False, False),
    # 600 tokens: the capacity branch, Mamba chunks at S = 300, drops
    "jamba-cut-capacity-drop": ("jamba", 2, 300, True, True),
    "phi-dense": ("phi", 2, 16, False, False),
    "phi-capacity-drop": ("phi", 2, 256, False, True),
    "moonshot-dense": ("moonshot", 2, 16, False, False),
    # the mLSTM at S = 300 (chunks of 256), the sLSTM over 300 steps
    "xlstm-ragged-chunk": ("xlstm", 1, 300, False, False),
    # an sLSTM of a few steps
    "xlstm-short": ("xlstm", 2, 5, False, False),
}


@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_f32_loss_and_gradients_match_the_reference(case, monkeypatch):
    arch, b, s, cut, crowd = F32_CASES[case]
    loss, rloss, aux, raux, pairs, drops = _loss_and_grads(
        arch, "float32", b, s, cut=cut, crowd=crowd,
        monkeypatch=monkeypatch)
    _hold(loss, rloss, aux, raux, pairs, "float32")
    rcfg, cfg = _cfgs(arch, "float32", cut)
    if cfg.num_experts:
        assert aux > 0.0
        assert moe.dense_branch(b * s) == case.endswith("dense")
    else:
        assert aux == 0.0 and raux == 0.0
    if crowd:
        assert drops["port"] > 0 and drops["ref"] == drops["port"], drops


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bf16_loss_and_gradients_match_the_reference(arch):
    """jamba as its two-layer cut ('a' then 'm' with the MoE): its MoE runs
    the reference op by op, and four layers of it take ~45 s."""
    loss, rloss, aux, raux, pairs, _ = _loss_and_grads(
        arch, "bfloat16", 2, 16, cut=arch == "jamba")
    _hold(loss, rloss, aux, raux, pairs, "bfloat16")


def test_trainer_restart_on_jamba_matches_an_uninterrupted_run(tmp_path):
    """jamba-smoke, 4 steps: checkpoints every 2 steps and a failure before
    step 3, restored and continued, against an uninterrupted run; the
    parameters and the optimizer state (the 3-D expert leaves included)
    agree."""
    cfg = dataclasses.replace(get_smoke_config(ARCHS["jamba"]),
                              dtype="float32")
    shape = ShapeSpec("t", 16, 2, "train")
    runs, losses = {}, {}
    for tag, kw in (("uninterrupted", dict(ckpt_every=4)),
                    ("restarted", dict(ckpt_every=2, fail_at_step=3))):
        t = Trainer(cfg, shape, TrainerConfig(
            ckpt_dir=str(tmp_path / tag), total_steps=10, warmup_steps=2,
            log_every=100, **kw), device="cpu")
        got = losses[tag] = {}
        real_run = t.run
        t.run = lambda steps=None: real_run(  # noqa: E731
            steps, on_metrics=lambda i, m: got.__setitem__(i, m))
        runs[tag] = t.run_with_restart(4)
    assert sorted(losses["restarted"]) == [0, 1, 2, 3]
    for i in range(4):
        a, b = losses["uninterrupted"][i], losses["restarted"][i]
        assert np.isfinite(a["loss"]) and a["aux"] > 0.0
        assert abs(a["loss"] - b["loss"]) <= 1e-6 * abs(a["loss"])
    assert losses["uninterrupted"][3]["loss"] < \
        losses["uninterrupted"][0]["loss"]
    params, opt = runs["restarted"]
    assert any(t.dim() == 3 for t in tree_leaves(opt["m"]))
    for x, y in zip(tree_leaves(runs["uninterrupted"]),
                    tree_leaves(runs["restarted"])):
        assert x.shape == y.shape
        assert torch.allclose(x.detach().float(), y.detach().float(),
                              rtol=1e-6, atol=1e-7)
