"""The port's training substrate against the JAX reference, on numpy inputs
made from a seed, at smoke sizes: the optimizer and the schedule, the
synthetic data, the trainer (from the same carried-over state), its
checkpoint and restart, the attention gradient's route off the CPU, and the
launcher.

Tolerances: the optimizer's float32 state within 1e-6 relative (the same
float32 arithmetic, fused differently by XLA), its bf16 parameters within
one bf16 step; the schedule within 1e-6; data bit for bit; five trainer
steps in f32 with losses within 1e-5 relative and parameters within 1e-5 of
each leaf's largest magnitude (the gradients differ in the last bits, as in
``test_torch_train_loss.py``, and Adam's normalised step carries that
through a learning rate of at most 3e-4)."""
import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.models.config import ShapeSpec as RefShapeSpec  # noqa: E402
from repro.train import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.train import SyntheticData as RefSyntheticData  # noqa: E402
from repro.train import Trainer as RefTrainer  # noqa: E402
from repro.train import TrainerConfig as RefTrainerConfig  # noqa: E402
from repro.train import adamw_update as ref_adamw_update  # noqa: E402
from repro.train import init_opt_state as ref_init_opt_state  # noqa: E402
from repro.train import input_specs as ref_input_specs  # noqa: E402
from repro.train import warmup_cosine as ref_warmup_cosine  # noqa: E402
from repro.train.optimizer import \
    clip_by_global_norm as ref_clip  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (lm_opt_state_from_jax,  # noqa: E402
                                 lm_params_from_jax)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import layers, loss_fn  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.train import (AdamWConfig, SyntheticData,  # noqa: E402
                               Trainer, TrainerConfig, adamw_update,
                               init_opt_state, input_specs, latest_step,
                               restore_checkpoint, save_checkpoint,
                               warmup_cosine)
from repro_torch.train.optimizer import (clip_by_global_norm,  # noqa: E402
                                         tree_leaves, tree_map)

# the module (``repro_torch.kernels`` exports its function of the same name)
fa = importlib.import_module("repro_torch.kernels.flash_attention")


def _t(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return (t.detach().double().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float64))


# -- optimizer and schedule ----------------------------------------------------

def _opt_tree(rng, scale):
    """A bf16/f32 tree of gradients or weights (the port's nested dicts and
    lists; the reference's dicts)."""
    return {"w": rng.standard_normal((8, 6)) * scale,
            "norm": rng.standard_normal((6,)) * scale,
            "layers": {"0": rng.standard_normal((3, 4)) * scale}}


def _as(tree, conv, dtypes):
    return {k: _as(v, conv, dtypes[k]) if isinstance(v, dict)
            else conv(v, dtypes[k]) for k, v in tree.items()}


DTYPES = {"w": "bfloat16", "norm": "float32", "layers": {"0": "float32"}}


def test_adamw_matches_the_reference_over_three_steps_with_clipping():
    rng = np.random.default_rng(0)
    w0 = _opt_tree(rng, 1.0)
    rparams = _as(w0, lambda a, d: jnp.asarray(a, d), DTYPES)
    params = _as(w0, lambda a, d: _t(np.asarray(jnp.asarray(a, d))), DTYPES)
    ocfg, rocfg = AdamWConfig(lr=1e-2), RefAdamWConfig(lr=1e-2)
    ropt, opt = ref_init_opt_state(rparams), init_opt_state(params)
    # gradient norms ~14 (clipped to 1), ~0.3 (not clipped), ~3 (clipped)
    for step, scale in enumerate((4.0, 0.1, 1.0)):
        g = _opt_tree(rng, scale)
        rgrads = _as(g, lambda a, d: jnp.asarray(a, d), DTYPES)
        grads = _as(g, lambda a, d: _t(np.asarray(jnp.asarray(a, d))),
                    DTYPES)
        lr_scale = 0.5 + 0.25 * step
        rparams, ropt, rm = ref_adamw_update(rgrads, ropt, rparams, rocfg,
                                             jnp.float32(lr_scale))
        params, opt, m = adamw_update(grads, opt, params, ocfg, lr_scale)
        assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) <= \
            1e-6 * float(rm["grad_norm"])
        assert int(opt["count"]) == int(ropt["count"]) == step + 1
        for key in ("master", "m", "v"):
            for got, want in zip(tree_leaves(opt[key]),
                                 jax.tree_util.tree_leaves(ropt[key])):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6,
                                           atol=1e-9)
        for got, want in zip(tree_leaves(params),
                             jax.tree_util.tree_leaves(rparams)):
            assert str(got.dtype).split(".")[1] == str(want.dtype)
            step_ = 2.0 ** -7 if got.dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(_np(got), _np(want), rtol=step_,
                                       atol=1e-9)
    g = _opt_tree(rng, 2.0)
    clipped, norm = clip_by_global_norm(
        _as(g, lambda a, d: _t(np.asarray(jnp.asarray(a, d))), DTYPES), 1.0)
    rclipped, rnorm = ref_clip(_as(g, lambda a, d: jnp.asarray(a, d),
                                   DTYPES), 1.0)
    assert abs(float(norm) - float(rnorm)) <= 1e-6 * float(rnorm)
    for got, want in zip(tree_leaves(clipped),
                         jax.tree_util.tree_leaves(rclipped)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6)


def test_warmup_cosine_matches_the_reference():
    for kw in (dict(warmup_steps=5, total_steps=20),
               dict(warmup_steps=0, total_steps=1, floor=0.3), {}):
        for step in range(31):
            want = float(ref_warmup_cosine(step, **kw))
            for s in (step, torch.tensor(step)):
                got = warmup_cosine(s, **kw)
                assert got.dtype == torch.float32 and got.dim() == 0
                assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-6)


# -- data ------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["llama3.2-1b", "musicgen-large",
                                  "qwen2-vl-2b"])
def test_synthetic_data_gives_the_references_bits(name):
    """Zipf tokens, embeddings and stub M-RoPE positions, and the decode
    batches, equal bit for bit; the specs match the reference's."""
    shape = ShapeSpec("t", 24, 3, "train")
    ref = RefSyntheticData(ref_smoke_config(name),
                           RefShapeSpec("t", 24, 3, "train"), seed=3)
    data = SyntheticData(get_smoke_config(name), shape, seed=3,
                         device="cpu")
    for step in (0, 1, 17):
        want, got = ref.batch(step), data.batch(step)
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == {"int32": torch.int32,
                                    "float32": torch.float32}[str(w.dtype)]
            assert np.array_equal(got[k].numpy(), w)
        w = ref.decode_batch(step)
        assert np.array_equal(data.decode_batch(step).numpy(), w)
    for kind in ("train", "prefill", "decode"):
        want = ref_input_specs(ref_smoke_config(name),
                               RefShapeSpec("t", 24, 3, kind))
        got = input_specs(get_smoke_config(name), ShapeSpec("t", 24, 3, kind))
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(w.shape)
            assert str(got[k].dtype).split(".")[1] == str(w.dtype)


# -- the trainer -------------------------------------------------------------------

def _carried(cfg, rparams, ropt):
    """Port parameters (needing gradients) and optimizer state carried over
    bit for bit from the reference's."""
    params = lm_params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, rparams), "cpu")
    opt = lm_opt_state_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, ropt), "cpu")
    for a, b in zip(tree_leaves(opt["master"]), tree_leaves(params)):
        assert torch.equal(a, b.float())
    tree_map(lambda p: p.requires_grad_(True), params)
    return params, opt


def test_five_trainer_steps_match_the_reference(tmp_path):
    name, shape = "llama3.2-1b", ("t", 32, 4, "train")
    rcfg = dataclasses.replace(ref_smoke_config(name), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(name), dtype="float32")
    tkw = dict(ckpt_every=100, total_steps=5, warmup_steps=2, log_every=100)
    ref = RefTrainer(rcfg, RefShapeSpec(*shape), RefTrainerConfig(
        ckpt_dir=str(tmp_path / "ref"), **tkw))
    # in f32 the reference's master weights are its parameters' own buffers
    # (``astype`` to the same dtype), and its jitted step, which donates
    # both trees, refuses to donate one buffer twice; the same values in
    # buffers of their own
    rp0, ropt0 = ref.init_state()
    ropt0 = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), ropt0)
    ref.init_state = lambda: (rp0, ropt0)
    state = _carried(cfg, rp0, ropt0)  # before the reference donates them
    want = []
    rparams, _ = ref.run(5, on_metrics=lambda s, m: want.append(m))
    port = Trainer(cfg, ShapeSpec(*shape), TrainerConfig(
        ckpt_dir=str(tmp_path / "port"), **tkw), device="cpu")
    port.init_state = lambda: state
    got = []
    params, opt = port.run(5, on_metrics=lambda s, m: got.append(m))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"loss", "ce", "aux", "grad_norm"}
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k])
    assert int(opt["count"]) == 5
    rflat = lm_params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                           rparams), "cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(rflat)):
        a, b = _np(a), _np(b)
        assert float(np.abs(a - b).max()) <= 1e-5 * float(np.abs(b).max())
    assert latest_step(str(tmp_path / "port")) == 5


@pytest.fixture()
def smoke_trainer(tmp_path):
    cfg = get_smoke_config("llama3.2-1b")
    shape = ShapeSpec("t", 32, 4, "train")

    def make(tag, steps, **kw):
        return Trainer(cfg, shape, TrainerConfig(
            ckpt_dir=str(tmp_path / tag), total_steps=steps, warmup_steps=2,
            log_every=100, **kw), device="cpu")

    return make


def test_restart_after_a_failure_equals_an_uninterrupted_run(smoke_trainer):
    """bf16, 8 steps: checkpoints every 4; the second run fails before step
    6, restores step 4 and goes on. On the CPU every op is deterministic, so
    the final parameters and optimizer state are equal bit for bit."""
    a = smoke_trainer("a", 8, ckpt_every=4)
    pa, oa = a.run(8)
    b = smoke_trainer("b", 8, ckpt_every=4, fail_at_step=6)
    pb, ob = b.run_with_restart(8)
    assert b.tcfg.fail_at_step is None
    for x, y in zip(tree_leaves((pa, oa)), tree_leaves((pb, ob))):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert latest_step(b.tcfg.ckpt_dir) == 8
    assert sorted(os.listdir(b.tcfg.ckpt_dir)) == ["step_00000004",
                                                   "step_00000008"]


def test_loss_decreases(smoke_trainer):
    t = smoke_trainer("c", 30, ckpt_every=100)
    losses = []
    t.run(30, on_metrics=lambda s, m: losses.append(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def test_a_mesh_is_not_ported():
    """What stays refused now that a mesh is ported: a mesh that is not a
    ``DeviceMesh``, and a knob that only a mesh reads without a mesh (it
    would be passed and then ignored)."""
    shape = ShapeSpec("t", 8, 2, "train")
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(get_smoke_config("llama3.2-1b"), shape, mesh=object(),
                device="cpu")
    from repro_torch.distributed.sharding import ExecutionPlan

    for knob in ("fsdp_params", "pure_dp", "grad_compression"):
        with pytest.raises(ValueError, match="need a mesh"):
            Trainer(get_smoke_config("llama3.2-1b"), shape,
                    plan=ExecutionPlan(**{knob: True}), device="cpu")


def test_the_plan_applies_what_one_device_reads_and_nothing_else():
    """``apply`` sets remat, the attention chunks and ``moe_impl`` as the
    reference's does; the mesh knobs (``fsdp_params``, ``grad_compression``,
    ``pure_dp``, ``seq_shard_decode``, and the dry run's
    ``attn_batch_reshard`` and ``shard_activation_ckpt``) and ``moe_impl``
    are fields with the reference's defaults, and a knob that nothing in the
    port reads (``scan_layers``: the port loops over its layers) is no
    field, so it cannot be passed and then ignored."""
    from repro.distributed.sharding import ExecutionPlan as RefPlan
    from repro_torch.distributed.sharding import ExecutionPlan

    knobs = dict(remat="none", attn_q_chunk=256, attn_kv_chunk=512,
                 moe_impl="ep")
    got = ExecutionPlan(**knobs).apply(get_smoke_config("llama3.2-1b"))
    want = RefPlan(**knobs).apply(ref_smoke_config("llama3.2-1b"))
    for name in knobs:
        assert getattr(got, name) == getattr(want, name) == knobs[name]
    for name in ("fsdp_params", "grad_compression", "pure_dp", "moe_impl",
                 "seq_shard_decode", "attn_batch_reshard",
                 "shard_activation_ckpt"):
        assert getattr(ExecutionPlan(), name) == getattr(RefPlan(), name)
    assert ExecutionPlan().moe_impl == "tp_ragged"
    default = ExecutionPlan().apply(get_smoke_config("llama3.2-1b"))
    assert default.moe_impl == "tp_ragged"
    for name in ("fsdp_params", "grad_compression", "pure_dp",
                 "seq_shard_decode", "attn_batch_reshard",
                 "shard_activation_ckpt"):
        assert getattr(ExecutionPlan(**{name: True}), name) is True
    with pytest.raises(TypeError):
        ExecutionPlan(scan_layers=True)


# -- checkpoints -----------------------------------------------------------------

def test_checkpoint_roundtrip_bf16(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3).to(
        torch.bfloat16) / 3,
            "b": {"c": torch.ones((4,)), "d": torch.tensor(7,
                                                           dtype=torch.int32)},
            "layers": [{"w": torch.full((2,), 0.1, dtype=torch.bfloat16)}]}
    save_checkpoint(str(tmp_path), 3, {"state": tree}, extra={"k": 1})
    step, out, extra = restore_checkpoint(str(tmp_path), {"state": tree})
    assert step == 3 and extra == {"k": 1}
    got = out["state"]
    for x, y in zip(tree_leaves(got), tree_leaves(tree)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert isinstance(got["layers"], list)
    z = np.load(os.path.join(tmp_path, "step_00000003", "state.npz"))
    assert z["a"].dtype == np.uint16 and set(z.files) == {
        "a", "b::c", "b::d", "layers::0::w"}


def test_checkpoint_gc_keep_last_and_a_leftover_tmp(tmp_path):
    tree = {"x": torch.zeros((2,))}
    for s in [1, 2, 3, 4, 5]:
        save_checkpoint(str(tmp_path), s, {"t": {"x": torch.full((2,),
                                                                 float(s))}},
                        keep_last=2)
    # a write that died before its rename leaves a .tmp directory behind
    os.makedirs(tmp_path / "step_00000009.tmp")
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000004", "step_00000005", "step_00000009.tmp"]
    assert latest_step(str(tmp_path)) == 5
    step, out, _ = restore_checkpoint(str(tmp_path), {"t": tree})
    assert step == 5 and torch.equal(out["t"]["x"], torch.full((2,), 5.0))
    save_checkpoint(str(tmp_path), 6, {"t": tree}, keep_last=2)
    assert sorted(d for d in os.listdir(tmp_path)) == [
        "step_00000005", "step_00000006", "step_00000009.tmp"]
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), {"t": tree})


# -- the attention gradient off the CPU --------------------------------------------

def test_backward_off_the_cpu_calls_only_the_kernel_entries(monkeypatch):
    """With its tensors taken for CUDA tensors, a training step through the
    chunked branch calls the forward kernel's entry twice a layer (forward
    and the checkpoint's recompute) and the backward kernel's entry once a
    layer, and never the plain twin: the training path has no route to a
    plain version on the card."""
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = fa.flash_attention, fa.flash_attention_bwd

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return real_fwd(*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return real_bwd(*a, **kw)

    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"),
                              dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    tree_map(lambda p: p.requires_grad_(True), params)
    data = SyntheticData(cfg, ShapeSpec("t", 2049, 1, "train"),
                         device="cpu")
    monkeypatch.setattr(layers, "on_cuda", lambda *t: True)
    monkeypatch.setattr(fa, "flash_attention", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)
    monkeypatch.setattr(layers, "flash_attention_xla",
                        lambda *a, **kw: pytest.fail("the plain twin ran"))
    loss, _ = loss_fn(cfg, params, data.batch(0))
    loss.backward()
    assert calls == {"fwd": 2 * cfg.num_layers, "bwd": cfg.num_layers}
    assert all(bool(torch.isfinite(p.grad).all())
               for p in tree_leaves(params))


def test_a_refused_gradient_raises_before_any_launch(monkeypatch):
    monkeypatch.setattr(fa, "on_cuda", lambda *t: True)
    monkeypatch.setattr(fa, "load_kernels", lambda: pytest.fail("launched"))
    q = torch.zeros((1, 4, 8, 16), requires_grad=True)
    k = torch.zeros((1, 2, 8, 16), requires_grad=True)
    for kw in (dict(causal=False), dict(causal=True, kv_len=4)):
        with pytest.raises(ValueError, match="backward takes causal"):
            fa.check_bwd(q, k, **kw)
    with pytest.raises(ValueError, match="backward takes causal"):
        fa.flash_attention_bwd(q, k, k, q, q, causal=False)
    with pytest.raises(ValueError, match="backward takes causal"):
        ops.attention(q, k[:, :, :6], k[:, :, :6], causal=True)
    with pytest.raises(ValueError, match="backward takes causal"):
        ops.attention(q, k, k, causal=False)
    with torch.no_grad():  # serving: the forward alone, which takes it
        monkeypatch.setattr(fa, "flash_attention",
                            lambda *a, **kw: torch.ones(1))
        assert ops.attention(q, k, k, causal=False).shape == (1,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_function_gives_the_plain_gradient_on_the_cpu(dtype):
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((2, h, 37, 32), generator=gen).to(dtype)
               .requires_grad_(True) for h in (6, 2, 2))
    out = ops.attention(q, k, v, causal=True)
    dout = torch.randn(out.shape, generator=gen).to(dtype)
    got = torch.autograd.grad(out, (q, k, v), dout)
    plain = fa.flash_attention_plain(q, k, v, causal=True)
    want = torch.autograd.grad(plain, (q, k, v), dout)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


# -- the launcher ------------------------------------------------------------------

def test_train_launcher_runs_on_the_cpu_and_refuses_a_mesh(tmp_path,
                                                           capsys):
    """The single-device path in this process; then what a mesh launch
    still refuses: a split that is not ``--devices``, and more ranks than
    the machine has cards (``tests/test_torch_mesh_launch.py`` runs a mesh
    of four gloo ranks)."""
    params, opt = train_launcher.main([
        "--smoke", "--device", "cpu", "--steps", "3", "--seq-len", "16",
        "--batch", "2", "--ckpt-dir", str(tmp_path)])
    assert int(opt["count"]) == 3 and latest_step(str(tmp_path)) == 3
    assert "[train] done" in capsys.readouterr().out
    refused = [["--device", "cpu", "--devices", "2", "--model-par", "4"],
               ["--device", "cpu", "--devices", "3", "--data-par", "2"]]
    many = max(2, torch.cuda.device_count() + 1)
    refused.append(["--devices", str(many), "--data-par", str(many)])
    for flags in refused:
        with pytest.raises(SystemExit) as e:
            train_launcher.main(["--smoke"] + flags)
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert "must = devices" in err or "CUDA devices" in err
