"""The port's training over a mesh against the JAX reference, on the CPU:
four ranks in spawned processes (gloo, one thread each, a file store under
the test's temporary directory), at smoke sizes in float32.

The oracle is the reference's single-device step (``loss_fn`` under
``jax.value_and_grad``, ``warmup_cosine``, ``adamw_update``), which is
what GSPMD's sharded step computes; the reference's own
``test_distributed.py`` fails on this tree and is no oracle. Each
scenario starts from the reference's initial state carried across and
takes 3 steps on the reference's batches. Tolerances: each step's loss
within 1e-5 relative; step 1's gradients, gathered to logical arrays,
within 1e-5 of each leaf's largest magnitude; the parameters after 3 steps
within 1e-5 absolute (the same float32 arithmetic, summed in other orders
across ranks). The int8-compressed trainer: losses within 5e-2 relative of
the uncompressed ones. The elastic restart: the losses of steps 3 and 4
after a restore under another mesh, or none, within 1e-5 relative of the
uninterrupted run's.

The MoE, Mamba and xLSTM archs over a 2 × 2 mesh (``MIXER_SCENARIOS``):
phi3.5-moe under ``tp_ragged`` and ``ep``, on the dense branch and on the
capacity branch (where, at these weights and batches, 170-280 of each
shard's 1,024 slots drop in each layer), jamba and
xlstm with ``fsdp_params``. Their oracle is the port on one device, the
reference's GSPMD semantics made explicit: on the capacity branch, which
the reference maps over the data shards, the mean over the data shards of
the loss on each shard's rows (its aux the shard's own, ``pmean``-ed), on
the dense branch the loss of the whole batch (the aux's shares taken over
the global batch), with their gradients; loss and gradients within 1e-5.
The port's ``tp_ragged`` and ``ep`` are also held to the reference's own
``shard_map`` branches on a (2, 2) mesh of forced host devices, in a
subprocess, on the dense and the capacity branch: loss, aux and every
gradient leaf within 1e-4.

All scenarios share one spawn of four ranks (``mesh_results``); the
reference's oracles are computed in this process while the ranks run."""
import dataclasses
import os
import pickle
import shutil
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (lm_opt_state_from_jax,  # noqa: E402
                                 lm_params_from_jax)
from repro_torch.distributed.sharding import (ExecutionPlan,  # noqa: E402
                                              map_specs)
from repro_torch.launch.mesh import (make_mesh,  # noqa: E402
                                     make_production_mesh, run_ranks)
from repro_torch.models import loss_fn, moe  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.data import SyntheticData  # noqa: E402
from repro_torch.train.optimizer import (init_opt_state,  # noqa: E402
                                         tree_leaves, tree_map)

SHAPE = ("t", 32, 4, "train")
STEPS = 3
TKW = dict(ckpt_every=100, total_steps=5, warmup_steps=2, log_every=100)

#: name → (arch, mesh shape over ("data", "model"), plan knobs)
SCENARIOS = {
    "llama_2x2": ("llama3.2-1b", (2, 2), {}),
    # llama's smoke config has 2 kv heads: at model width 4 they do not tile
    "llama_1x4": ("llama3.2-1b", (1, 4), {}),
    # 6 q heads do not tile 4: attention is replicated (attn_tp false);
    # untied lm_head, GELU MLP
    "starcoder2_1x4": ("starcoder2-7b", (1, 4), {}),
    # embeddings input with M-RoPE positions
    "qwen2vl_2x2": ("qwen2-vl-2b", (2, 2), {}),
    # q/k norms, whose scales only the local heads use, with whole kv
    # projections (2 kv heads at model width 4)
    "qwen3_1x4": ("qwen3-1.7b", (1, 4), {}),
    "llama_fsdp_2x2": ("llama3.2-1b", (2, 2), dict(fsdp_params=True)),
    "llama_pure_dp_4": ("llama3.2-1b", (4, 1), dict(pure_dp=True)),
    "llama_compressed_4": ("llama3.2-1b", (4, 1),
                           dict(grad_compression=True)),
}
ORACLE = {"llama_compressed_4": None}

PHI = "phi3.5-moe-42b-a6.6b"
#: name → (arch, mesh shape, plan knobs, (S, global batch), crowded
#: routing): 128 tokens take the MoE's dense branch, 4 × 256 its capacity
#: branch (512 a data shard, where slots drop)
MIXER_SCENARIOS = {
    "phi_tp_dense": (PHI, (2, 2), dict(moe_impl="tp_ragged"), (32, 4), False),
    "phi_tp_capacity": (PHI, (2, 2), dict(moe_impl="tp_ragged"), (256, 4),
                        False),
    "phi_ep_dense": (PHI, (2, 2), dict(moe_impl="ep"), (32, 4), False),
    "phi_ep_capacity": (PHI, (2, 2), dict(moe_impl="ep"), (256, 4), False),
    "jamba_fsdp": ("jamba-v0.1-52b", (2, 2), dict(fsdp_params=True),
                   (32, 4), False),
    "xlstm_fsdp": ("xlstm-125m", (2, 2), dict(fsdp_params=True), (16, 4),
                   False),
}
#: the reference's ``moe_ffn`` under ``shard_map`` on a (2, 2) mesh against
#: the port's: phi's smoke config in float32, the reference's weights;
#: name → (moe_impl, (global batch, S)): 4 × 32 tokens take the dense
#: branch, 8 × 128 the capacity branch (512 a data shard)
REF_MOE_CASES = {
    "tp_ragged_dense": ("tp_ragged", (4, 32)),
    "tp_ragged_capacity": ("tp_ragged", (8, 128)),
    "ep_dense": ("ep", (4, 32)),
    "ep_capacity": ("ep", (8, 128)),
}


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _np(t):
    return t.detach().double().numpy()


# -- the ranks (no JAX here: every function below runs in the children) -------

def _scenario(rank, out, name, state):
    arch, shape, knobs = SCENARIOS[name]
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    t = Trainer(_cfg(arch), ShapeSpec(*SHAPE), TrainerConfig(
        ckpt_dir=os.path.join(out, name), **TKW), mesh=mesh,
        plan=ExecutionPlan(**knobs), device="cpu")
    cfg = t.cfg
    params, opt = t.from_logical(lm_params_from_jax(cfg, state[0], "cpu"),
                                 lm_opt_state_from_jax(cfg, state[1], "cpu"))
    losses, grads1 = [], None
    for step in range(STEPS):
        metrics, grads = t.gradients(params, t.batch(step))
        if step == 1:
            grads1 = [_np(g) for g in tree_leaves(_gather(t, grads))]
        params, opt, om = t.apply_gradients(params, opt, grads, step)
        losses.append((float(metrics["loss"]), float(om["grad_norm"])))
    return dict(losses=losses, grads1=grads1,
                params=[_np(p) for p in tree_leaves(_gather(t, params))],
                count=int(opt["count"]))


def _gather(t, tree):
    """The logical tensors of a tree laid out like the parameters."""
    return map_specs(lambda s, x: s.gather(x.detach()), t.shardings["params"],
                     tree)


def _elastic(rank, out):
    """Two steps at 2 × 2 checkpointed; four uninterrupted at 2 × 2; the
    checkpoint restored at 1 × 4 and trained to step 4."""
    import torch.distributed as dist

    cfg, shape = _cfg("llama3.2-1b"), ShapeSpec(*SHAPE)
    d = os.path.join(out, "elastic")

    def trainer(tag, mesh_shape):
        mesh = make_mesh(mesh_shape, ("data", "model"), "cpu")
        return Trainer(cfg, shape, TrainerConfig(
            ckpt_dir=os.path.join(d, tag), ckpt_every=2, total_steps=5,
            warmup_steps=2, log_every=100), mesh=mesh, device="cpu")

    trainer("saved", (2, 2)).run(2)
    if rank == 0:
        for tag in ("restored_1x4", "restored_no_mesh"):
            shutil.copytree(os.path.join(d, "saved"), os.path.join(d, tag))
    dist.barrier()
    losses = {}
    for tag, mesh_shape in (("uninterrupted", (2, 2)),
                            ("restored_1x4", (1, 4))):
        got = losses[tag] = []
        trainer(tag, mesh_shape).run(4, on_metrics=lambda s, m: got.append(
            (s, m["loss"])))
    return losses


def _refusals(rank):
    """What a mesh trainer refuses (a global batch that does not divide
    over the data ranks, an axis the mesh lacks), a production mesh the
    world is too small for, and CUDA tensors over gloo."""
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = []
    for shape, kw in ((("t", 32, 3, "train"), {}),
                      (SHAPE, dict(mesh_axes=("data", "pipe")))):
        try:
            Trainer(_cfg("llama3.2-1b"), ShapeSpec(*shape), mesh=mesh,
                    device="cpu", data_axes=kw.get("mesh_axes", ("data",))
                    [:1], model_axis=kw.get("mesh_axes", (0, "model"))[1])
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    try:  # 16 x 16 ranks
        make_production_mesh(device="cpu")
        out.append(None)
    except ValueError as e:
        out.append(str(e))
    # a CUDA tensor over a gloo group: the collectives never fall back
    import types

    from repro_torch.distributed import collectives

    cuda = types.SimpleNamespace(is_cuda=True, device=torch.device("cuda"))
    try:
        collectives._check(cuda, mesh.get_group("data"))
        out.append(None)
    except RuntimeError as e:
        out.append(str(e))
    return out


def _mixer_params(cfg, crowd: bool):
    """Seeded logical parameters; with ``crowd`` every embedding entry
    moved by +1, so that the tokens share a direction and routing crowds
    a few experts (slots drop on the capacity branch)."""
    params = init_params(cfg, torch.Generator().manual_seed(0))
    if crowd:
        params["embed"] = params["embed"] + 1.0
    return params


def _mixer_scenario(rank, out, name):
    """One gradient of the first batch: the mean loss and aux over the data
    ranks, and the logical gradients."""
    arch, shape, knobs, (s, b), crowd = MIXER_SCENARIOS[name]
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    t = Trainer(_cfg(arch), ShapeSpec("t", s, b, "train"), TrainerConfig(
        ckpt_dir=os.path.join(out, name), **TKW), mesh=mesh,
        plan=ExecutionPlan(**knobs), device="cpu")
    logical = _mixer_params(t.cfg, crowd)
    params, _ = t.from_logical(logical, init_opt_state(logical))
    metrics, grads = t.gradients(params, t.batch(0))
    return dict(loss=float(metrics["loss"]), aux=float(metrics["aux"]),
                grads=[_np(g) for g in tree_leaves(_gather(t, grads))])


def _moe_against_the_reference(rank, out, state, name):
    """The port's loss, aux and logical gradients of phi (float32, the
    reference's weights) on a 2 × 2 mesh under one of ``REF_MOE_CASES``,
    over the batch the reference's subprocess takes."""
    impl, (b, s) = REF_MOE_CASES[name]
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    t = Trainer(_cfg(PHI), ShapeSpec("t", s, b, "train"), TrainerConfig(
        ckpt_dir=os.path.join(out, "ref_" + name), **TKW), mesh=mesh,
        plan=ExecutionPlan(moe_impl=impl), device="cpu")
    params, _ = t.from_logical(lm_params_from_jax(t.cfg, state[0], "cpu"),
                               lm_opt_state_from_jax(t.cfg, state[1], "cpu"))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, t.cfg.vocab_size, (b, s)
                                              ).astype(np.int32))
             for k in ("tokens", "labels")}
    sh = t.shardings["batch"]
    batch = {k: sh[k].shard(v).contiguous() for k, v in batch.items()}
    metrics, grads = t.gradients(params, batch)
    return dict(loss=float(metrics["loss"]), aux=float(metrics["aux"]),
                grads=[_np(g) for g in tree_leaves(_gather(t, grads))])


def _ranks_main(rank, out):
    with open(os.path.join(out, "states.pkl"), "rb") as f:
        states = pickle.load(f)
    results = {name: _scenario(rank, out, name, states[SCENARIOS[name][0]])
               for name in SCENARIOS}
    results["elastic"] = _elastic(rank, out)
    results["refusals"] = _refusals(rank)
    for name in MIXER_SCENARIOS:
        results[name] = _mixer_scenario(rank, out, name)
    results["ref_moe"] = {name: _moe_against_the_reference(
        rank, out, states[PHI], name) for name in REF_MOE_CASES}
    if rank == 0:
        with open(os.path.join(out, "results.pkl"), "wb") as f:
            pickle.dump(results, f)


# -- the reference, in this process --------------------------------------------

def _reference_state(arch):
    import jax

    from repro.configs import get_smoke_config as ref_smoke_config
    from repro.models import init_params as ref_init_params
    from repro.train import init_opt_state as ref_init_opt_state

    rcfg = dataclasses.replace(ref_smoke_config(arch), dtype="float32")
    rp, ropt = jax.jit(lambda key: (lambda p: (p, ref_init_opt_state(p)))(
        ref_init_params(rcfg, key)))(jax.random.PRNGKey(0))
    to_np = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda x: np.array(x), tree)
    return rcfg, rp, ropt, (to_np(rp), to_np(ropt))


def _reference_run(rcfg, rp, ropt):
    import jax

    from repro.models import loss_fn as ref_loss_fn
    from repro.models.config import ShapeSpec as RefShapeSpec
    from repro.train import AdamWConfig as RefAdamWConfig
    from repro.train import SyntheticData as RefSyntheticData
    from repro.train import adamw_update as ref_adamw_update
    from repro.train import warmup_cosine as ref_warmup_cosine

    @jax.jit
    def step_fn(p, o, batch, step):
        (loss, _), g = jax.value_and_grad(
            lambda p: ref_loss_fn(rcfg, p, batch), has_aux=True)(p)
        lr = ref_warmup_cosine(step, warmup_steps=TKW["warmup_steps"],
                               total_steps=TKW["total_steps"])
        p, o, om = ref_adamw_update(g, o, p, RefAdamWConfig(), lr)
        return p, o, loss, om["grad_norm"], g

    data = RefSyntheticData(rcfg, RefShapeSpec(*SHAPE), seed=0)
    losses, grads1 = [], None
    for step in range(STEPS):
        rp, ropt, loss, gn, g = step_fn(rp, ropt, data.batch(step), step)
        losses.append((float(loss), float(gn)))
        if step == 1:
            grads1 = g
    return losses, grads1, rp


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    import jax

    out = str(tmp_path_factory.mktemp("mesh"))
    archs = sorted({a for a, _, _ in SCENARIOS.values()})
    refs = {a: _reference_state(a) for a in archs + [PHI]}
    # the states travel in a file: as spawn arguments a few MB took ~12 s
    # to reach the ranks
    with open(os.path.join(out, "states.pkl"), "wb") as f:
        pickle.dump({a: refs[a][3] for a in archs + [PHI]}, f)
    err = []

    def ranks():
        try:
            run_ranks(_ranks_main, 4, os.path.join(out, "store"),
                      args=(out,), device="cpu", timeout=240)
        except BaseException as e:  # re-raised in the test's thread
            err.append(e)

    th = threading.Thread(target=ranks)
    th.start()
    oracles = {name: _mixer_oracle(name) for name in MIXER_SCENARIOS}
    for a in archs:
        rcfg, rp, ropt, _ = refs[a]
        cfg = _cfg(a)
        losses, g1, pf = _reference_run(rcfg, rp, ropt)
        flat = lambda tree: [_np(t) for t in tree_leaves(  # noqa: E731
            lm_params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, tree),
                               "cpu"))]
        oracles[a] = dict(losses=losses, grads1=flat(g1), params=flat(pf))
    th.join(timeout=300)
    if err:
        raise err[0]
    assert not th.is_alive(), "the ranks did not finish"
    with open(os.path.join(out, "results.pkl"), "rb") as f:
        results = pickle.load(f)
    return results, oracles, out


def _check_losses(got, want, rtol):
    assert len(got) == len(want)
    for (gl, gn), (wl, wn) in zip(got, want):
        assert abs(gl - wl) <= rtol * abs(wl), (got, want)
        assert abs(gn - wn) <= rtol * abs(wn), (got, want)


@pytest.mark.parametrize("name", [n for n in SCENARIOS if n not in ORACLE])
def test_mesh_steps_match_the_single_device_reference(mesh_results, name):
    """Losses, step 1's logical gradients and the parameters after three
    steps, against the reference's single-device step."""
    results, oracles, _ = mesh_results
    got = results[name]
    assert not isinstance(got, str), got
    want = oracles[SCENARIOS[name][0]]
    _check_losses(got["losses"], want["losses"], 1e-5)
    assert got["count"] == STEPS
    assert len(got["grads1"]) == len(want["grads1"])
    for g, w in zip(got["grads1"], want["grads1"]):
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= 1e-5 * float(np.abs(w).max())
    for p, w in zip(got["params"], want["params"]):
        assert p.shape == w.shape
        assert float(np.abs(p - w).max()) <= 1e-5


def test_compressed_gradients_train_close_to_exact(mesh_results):
    """int8 + error feedback over 4 data ranks: each step's loss within
    5e-2 relative of the uncompressed reference's, all finite."""
    results, oracles, _ = mesh_results
    got = results["llama_compressed_4"]
    assert not isinstance(got, str), got
    want = oracles["llama3.2-1b"]["losses"]
    for (gl, _), (wl, _) in zip(got["losses"], want):
        assert np.isfinite(gl) and abs(gl - wl) <= 5e-2 * abs(wl)


def test_elastic_restart_under_another_mesh_and_none(mesh_results):
    """A checkpoint saved at 2 × 2 after two steps restores at 1 × 4 and
    with no mesh, and trains to the uninterrupted run's losses at steps 3
    and 4."""
    results, _, out = mesh_results
    got = results["elastic"]
    unint = dict(got["uninterrupted"])
    assert sorted(unint) == [0, 1, 2, 3]
    restored = dict(got["restored_1x4"])
    assert sorted(restored) == [2, 3]
    t = Trainer(_cfg("llama3.2-1b"), ShapeSpec(*SHAPE), TrainerConfig(
        ckpt_dir=os.path.join(out, "elastic", "restored_no_mesh"),
        ckpt_every=2, total_steps=5, warmup_steps=2, log_every=100),
        device="cpu")
    none = {}
    t.run(4, on_metrics=lambda s, m: none.__setitem__(s, m["loss"]))
    assert sorted(none) == [2, 3]
    for s in (2, 3):
        for other in (restored[s], none[s]):
            assert abs(other - unint[s]) <= 1e-5 * abs(unint[s])


def test_mesh_trainer_refuses_what_it_cannot_lay_out(mesh_results):
    """A mesh that is not a DeviceMesh; on a 2 × 2 mesh, a global batch of
    3 rows over 2 data ranks and a model axis the mesh does not have; the
    production mesh over a world of four ranks; a collective of CUDA
    tensors over a gloo group."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(_cfg("llama3.2-1b"), ShapeSpec(*SHAPE), mesh=object(),
                device="cpu")
    batch, axis, production, gloo = mesh_results[0]["refusals"]
    assert batch is not None and "does not divide over 2 data ranks" in batch
    assert axis is not None and "not in the mesh" in axis
    assert production is not None and "needs 256 ranks" in production
    assert gloo is not None and "runs nccl; the group runs gloo" in gloo


# -- the MoE, Mamba and xLSTM archs ---------------------------------------------

def _mixer_oracle(name):
    """The port on one device: the loss and gradients of the whole batch
    on the dense branch (and without experts), else the mean over the data
    shards of each shard's."""
    arch, shape, knobs, (s, b), crowd = MIXER_SCENARIOS[name]
    cfg = dataclasses.replace(_cfg(arch), **{
        k: v for k, v in knobs.items() if k == "moe_impl"})
    params = _mixer_params(cfg, crowd)
    tree_map(lambda p: p.requires_grad_(True), params)
    batch = SyntheticData(cfg, ShapeSpec("t", s, b, "train"), seed=0,
                          device="cpu").batch(0)
    n_data = shape[0]
    mesh = moe.MoeMesh(None, 1, None, n_data)
    capacity = cfg.num_experts and not moe.dense_branch(b // n_data * s,
                                                        mesh)
    shards = n_data if capacity else 1
    total, auxes = 0.0, []
    for i in range(shards):
        rows = slice(i * b // shards, (i + 1) * b // shards)
        loss, m = loss_fn(cfg, params, {k: v[rows] for k, v in batch.items()})
        total = total + loss / shards
        auxes.append(float(m["aux"].detach()))
    total.backward()
    return dict(loss=float(total.detach()), aux=sum(auxes) / shards,
                grads=[_np(p.grad) for p in tree_leaves(params)],
                capacity=bool(capacity))


@pytest.mark.parametrize("name", list(MIXER_SCENARIOS))
def test_mixer_archs_over_a_mesh_match_the_one_device_oracle(mesh_results,
                                                             name):
    """The mean loss, its aux and the logical gradients over the 2 × 2
    mesh against the one-device oracle of the same branch."""
    results, oracles, _ = mesh_results
    got, want = results[name], oracles[name]
    assert want["capacity"] == name.endswith("capacity")
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert abs(got["aux"] - want["aux"]) <= 1e-5 * max(abs(want["aux"]),
                                                       1e-30)
    if "phi" in name or "jamba" in name:
        assert want["aux"] > 0.0
    assert len(got["grads"]) == len(want["grads"])
    for g, w in zip(got["grads"], want["grads"]):
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= 1e-5 * max(
            float(np.abs(w).max()), 1e-30)


@pytest.fixture(scope="module")
def reference_moe(tmp_path_factory):
    """``jax.value_and_grad`` of the reference's ``loss_fn`` under
    ``mesh_context`` on a (2, 2) mesh of forced host devices, for each of
    ``REF_MOE_CASES``, in one subprocess (as the reference's own
    ``test_moe_ep_variant_compiles_and_matches`` runs it): name → (loss,
    aux, gradients as the port's logical leaves). The mesh's axes are
    ``Auto``, GSPMD's propagation: under JAX's default of ``Explicit``
    axes the reference's backward refuses the router's product over the
    data-sharded tokens."""
    import subprocess
    import sys
    import textwrap

    import jax

    path = str(tmp_path_factory.mktemp("ref_moe") / "ref_moe.pkl")
    code = textwrap.dedent(f"""
        import dataclasses, pickle
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs import get_smoke_config
        from repro.models import init_params, loss_fn
        from repro.distributed.meshctx import MeshContext, mesh_context
        auto = (jax.sharding.AxisType.Auto,) * 2
        mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=auto)
        base = dataclasses.replace(get_smoke_config({PHI!r}),
                                   dtype="float32")
        params = init_params(base, jax.random.PRNGKey(0))
        out = {{}}
        for name, (impl, (b, s)) in {REF_MOE_CASES!r}.items():
            cfg = dataclasses.replace(base, moe_impl=impl)
            rng = np.random.default_rng(0)
            batch = {{k: jnp.asarray(rng.integers(0, cfg.vocab_size, (b, s)),
                                    jnp.int32) for k in ("tokens", "labels")}}
            f = jax.value_and_grad(lambda p, x: loss_fn(cfg, p, x),
                                   has_aux=True)
            with mesh_context(MeshContext(mesh, ("data",), "model")):
                (loss, m), g = jax.jit(f)(params, batch)
            out[name] = (float(loss), float(m["aux"]),
                         jax.tree_util.tree_map(np.asarray, g))
        with open({path!r}, "wb") as fh:
            pickle.dump(out, fh)
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    with open(path, "rb") as f:
        raw = pickle.load(f)
    cfg = _cfg(PHI)
    return {name: (loss, aux, [_np(t) for t in tree_leaves(
        lm_params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, g),
                           "cpu"))])
            for name, (loss, aux, g) in raw.items()}


@pytest.mark.parametrize("name", list(REF_MOE_CASES))
def test_moe_impls_match_the_references_shard_map(mesh_results,
                                                  reference_moe, name):
    """The port's ``tp_ragged`` and ``ep`` on four gloo ranks against the
    reference's under ``shard_map`` on the dense and the capacity branch:
    the loss and aux within 1e-4 relative, each logical gradient leaf
    within 1e-4 of its largest magnitude."""
    got = mesh_results[0]["ref_moe"][name]
    loss, aux, grads = reference_moe[name]
    assert abs(got["loss"] - loss) <= 1e-4 * abs(loss), (got["loss"], loss)
    assert aux > 0.0
    assert abs(got["aux"] - aux) <= 1e-4 * abs(aux), (got["aux"], aux)
    assert len(got["grads"]) == len(grads)
    for g, w in zip(got["grads"], grads):
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= 1e-4 * max(
            float(np.abs(w).max()), 1e-30)
