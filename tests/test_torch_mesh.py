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
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

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


def _ranks_main(rank, out):
    with open(os.path.join(out, "states.pkl"), "rb") as f:
        states = pickle.load(f)
    results = {name: _scenario(rank, out, name, states[SCENARIOS[name][0]])
               for name in SCENARIOS}
    results["elastic"] = _elastic(rank, out)
    results["refusals"] = _refusals(rank)
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
    refs = {a: _reference_state(a) for a in archs}
    # the states travel in a file: as spawn arguments a few MB took ~12 s
    # to reach the ranks
    with open(os.path.join(out, "states.pkl"), "wb") as f:
        pickle.dump({a: refs[a][3] for a in archs}, f)
    err = []

    def ranks():
        try:
            run_ranks(_ranks_main, 4, os.path.join(out, "store"),
                      args=(out,), device="cpu", timeout=240)
        except BaseException as e:  # re-raised in the test's thread
            err.append(e)

    th = threading.Thread(target=ranks)
    th.start()
    oracles = {}
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
