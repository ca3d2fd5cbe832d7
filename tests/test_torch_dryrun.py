"""The port's dry run (``repro_torch.launch.dryrun``), its op count
(``repro_torch.launch.op_analysis``) and the two knobs only the dry run's
plans set, on the CPU.

(a) The trace predicts the real step: rank 0's meta-tensor trace of a
smoke train cell over a fake 2 × 2 group against rank 0 of a real 2 × 2
gloo step of the same cell (and starcoder2 at 1 × 4): equal collective
calls and bytes by kind, equal dot FLOPs, equal argument bytes.
(b) The op count against the reference's ``analyze_hlo`` of the
reference's compiled smoke prefill and decode cells on one device: dot
FLOPs within 1e-6 relative. Both count every product of the same model
(XLA fuses no product on the CPU, and the port's eager products are the
reference's dots), so they are equal (23,199,744 and 557,056 here); the
tolerance admits only the rounding of float sums.
(c) ``attn_batch_reshard`` on starcoder2 smoke at 1 × 4 (6 q heads do not
tile 4): the loss and every gradient with the knob on equal those with it
off within 1e-5 of each leaf's largest magnitude in float32 (the batch's
sums over the model ranks are taken in another order), and the counts
show the model-axis gathers (one forward, one backward, and the
recompute's forward, a layer). (d) ``shard_activation_ckpt`` at 2 × 2: the
same values with the knob on, and the trace's ``temp`` falls (at a deeper
cell). (e) The statuses. (f) The CLI writes a record with the reference's
keys.

All the ranks share one spawn of four; the traces run in this process
meanwhile."""
import dataclasses
import json
import os
import pickle
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.device import dry_run  # noqa: E402
from repro_torch.distributed.sharding import (ExecutionPlan,  # noqa: E402
                                              map_specs)
from repro_torch.launch.dryrun import (build_cell,  # noqa: E402
                                       cell_is_applicable, main, run_cell,
                                       trace_cell)
from repro_torch.launch.mesh import (fake_ranks, make_mesh,  # noqa: E402
                                     run_ranks)
from repro_torch.launch.op_analysis import OpCount, tensor_bytes  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

SHAPE = ("t", 32, 4, "train")
#: name → (arch, mesh shape over ("data", "model"), plan knobs)
CASES = {
    "llama_fsdp": ("llama3.2-1b", (2, 2), dict(fsdp_params=True)),
    "llama_actshard": ("llama3.2-1b", (2, 2),
                       dict(fsdp_params=True, shard_activation_ckpt=True)),
    "starcoder2": ("starcoder2-7b", (1, 4), {}),
    "starcoder2_reshard": ("starcoder2-7b", (1, 4),
                           dict(attn_batch_reshard=True)),
}
#: the reference record's keys (``repro/launch/dryrun.py`` :196-232), less
#: XLA's own (``t_lower_s``, ``t_compile_s``, ``cost_analysis``)
RECORD_KEYS = {"arch", "shape", "mesh", "plan", "model_params",
               "active_params", "status", "n_chips", "memory",
               "resident_bytes", "fits_hbm", "hlo", "per_device",
               "roofline"}


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


# -- the ranks (no JAX here: every function below runs in the children) -------

def _case(out, name):
    """One gradient of the first batch gathered to logical arrays, then one
    counted ``Trainer.step`` from a fresh state."""
    arch, shape, knobs = CASES[name]
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    t = Trainer(_cfg(arch), ShapeSpec(*SHAPE), TrainerConfig(
        ckpt_dir=os.path.join(out, name)), mesh=mesh,
        plan=ExecutionPlan(**knobs), device="cpu")
    params, _ = t.init_state()
    metrics, grads = t.gradients(params, t.batch(0))
    logical = map_specs(lambda s, g: s.gather(g), t.shardings["params"],
                        grads)
    params, opt = t.init_state()
    batch = t.batch(0)
    argument = tensor_bytes((params, opt, batch))
    with OpCount() as oc:
        t.step(params, opt, batch, 0)
    return dict(loss=float(metrics["loss"]),
                grads=[g.double().numpy() for g in tree_leaves(logical)],
                hlo=oc.stats(), collectives=oc.collectives(),
                argument=argument)


def _ranks_main(rank, out):
    got = {name: _case(out, name) for name in CASES}
    if rank == 0:
        with open(os.path.join(out, "results.pkl"), "wb") as f:
            pickle.dump(got, f)


# -- this process -----------------------------------------------------------------

def _trace(cfg, shape, mesh_shape, knobs):
    """Rank 0's dry run of the cell: (the cell, trace_cell's result)."""
    n = int(np.prod(mesh_shape))
    with dry_run(), fake_ranks(n):
        mesh = make_mesh(mesh_shape, ("data", "model"))
        cell = build_cell(cfg, shape, mesh, ("data",), "model",
                          ExecutionPlan(**knobs))
        return cell, trace_cell(cell)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    err = []

    def ranks():
        try:
            run_ranks(_ranks_main, 4, os.path.join(out, "store"),
                      args=(out,), device="cpu", timeout=240)
        except BaseException as e:  # re-raised in the test's thread
            err.append(e)

    th = threading.Thread(target=ranks)
    th.start()
    traces = {name: _trace(_cfg(arch), ShapeSpec(*SHAPE), shape, knobs)
              for name, (arch, shape, knobs) in CASES.items()}
    th.join(timeout=300)
    if err:
        raise err[0]
    assert not th.is_alive(), "the ranks did not finish"
    with open(os.path.join(out, "results.pkl"), "rb") as f:
        return pickle.load(f), traces


@pytest.mark.parametrize("name", list(CASES))
def test_the_trace_predicts_the_real_step(results, name):
    real, traces = results
    got, (cell, traced) = real[name], traces[name]
    hlo = traced["hlo"]
    assert hlo.collective_counts == got["hlo"].collective_counts
    assert hlo.collective_bytes == got["hlo"].collective_bytes
    assert hlo.dot_flops == got["hlo"].dot_flops > 0
    assert cell.argument == got["argument"]
    assert traced["devices"] == ["meta"]
    assert traced["memory"]["alias"] < traced["memory"]["argument"]


@pytest.mark.parametrize("off,on", [("starcoder2", "starcoder2_reshard"),
                                    ("llama_fsdp", "llama_actshard")])
def test_the_knobs_change_no_value(results, off, on):
    real, _ = results
    a, b = real[off], real[on]
    assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(a["loss"])
    assert len(a["grads"]) == len(b["grads"])
    for x, y in zip(a["grads"], b["grads"]):
        assert np.abs(x - y).max() <= 1e-5 * max(np.abs(x).max(), 1e-30)


def test_the_reshard_gathers_over_the_model_axis(results):
    """Each layer gathers its attention output over the model group in the
    forward and again in the recompute, and its input's gradient in the
    backward; the replicated attention leaves and norm1 are summed over
    it (copy_to: five all-reduces a layer)."""
    real, _ = results
    layers = _cfg("starcoder2-7b").num_layers
    off = real["starcoder2"]["collectives"]
    on = real["starcoder2_reshard"]["collectives"]
    assert (on["all_gather"]["calls"] - off["all_gather"]["calls"]
            == 3 * layers)
    assert (on["all_reduce_sum"]["calls"] - off["all_reduce_sum"]["calls"]
            == 5 * layers)


def test_the_sharded_checkpoint_cuts_temp():
    """At 4 layers and 8 × 128 tokens, where the layers' saved inputs
    outweigh the recompute's gathered input (at the spawn's 2 layers and
    4 × 32 they do not)."""
    cfg = dataclasses.replace(_cfg("llama3.2-1b"), num_layers=4)
    shape = ShapeSpec("t", 128, 8, "train")
    off, on = (_trace(cfg, shape, (2, 2), dict(
        fsdp_params=True, shard_activation_ckpt=knob))[1]["memory"]
        for knob in (False, True))
    assert on["argument"] == off["argument"]
    assert on["temp"] < off["temp"]


# -- (b) the op count against the reference's HLO analysis ---------------------

def _ref_dot_flops(kind, b, s):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as ref_smoke
    from repro.launch.hlo_analysis import analyze_hlo
    from repro.models import transformer as rt

    cfg = ref_smoke("llama3.2-1b")
    p = jax.eval_shape(lambda: rt.init_params(cfg, jax.random.PRNGKey(0)))
    if kind == "prefill":
        tok = jax.ShapeDtypeStruct((b, s), jnp.int32)
        fn = jax.jit(lambda p, t: rt.prefill(cfg, p, {"tokens": t},
                                             max_seq=s))
        args = (p, tok)
    else:
        cache = jax.eval_shape(lambda: rt.init_cache(cfg, b, s))
        tok = jax.ShapeDtypeStruct((b, 1), jnp.int32)
        fn = jax.jit(lambda p, c, t: rt.decode_step(cfg, p, c, t))
        args = (p, cache, tok)
    return analyze_hlo(fn.lower(*args).compile().as_text()).dot_flops


def _port_dot_flops(kind, b, s):
    from repro_torch.models.transformer import (decode_step, init_cache,
                                                init_params, prefill)

    cfg = get_smoke_config("llama3.2-1b")
    with dry_run(), torch.no_grad():
        params = init_params(cfg, None)
        if kind == "prefill":
            tok = torch.empty((b, s), dtype=torch.int32, device="meta")
            with OpCount() as oc:
                prefill(cfg, params, {"tokens": tok}, max_seq=s)
        else:
            cache = init_cache(cfg, b, s)
            tok = torch.empty((b, 1), dtype=torch.int32, device="meta")
            with OpCount() as oc:
                decode_step(cfg, params, cache, tok)
    return oc.stats().dot_flops


@pytest.mark.parametrize("kind,b,s", [("prefill", 2, 64),
                                      ("decode", 2, 128)])
def test_the_op_count_matches_the_reference_hlo(kind, b, s):
    want = _ref_dot_flops(kind, b, s)
    got = _port_dot_flops(kind, b, s)
    assert want > 0
    assert abs(got - want) <= 1e-6 * want, (got, want)


# -- (e) statuses, (f) the CLI ----------------------------------------------------

def test_statuses(tmp_path):
    assert cell_is_applicable(get_config("llama3.2-1b"),
                              SHAPES["long_500k"]).startswith("skipped")
    assert cell_is_applicable(get_config("xlstm-125m"),
                              SHAPES["long_500k"]) is None
    assert cell_is_applicable(get_config("llama3.2-1b"),
                              SHAPES["decode_32k"]) is None
    rec = run_cell("llama3.2-1b", "long_500k", out_dir=str(tmp_path),
                   verbose=False)
    assert rec["status"].startswith("skipped")
    # 8 kv heads do not tile 16: the cache's sequence is split over the
    # model axis, which only seq_shard_decode decodes
    rec = run_cell("llama3.2-1b", "decode_32k", out_dir=str(tmp_path),
                   verbose=False)
    assert rec["status"].startswith("cannot run"), rec["status"]
    assert "seq_shard_decode" in rec["status"]
    with open(tmp_path / "pod16x16" / "llama3.2-1b__decode_32k.json") as f:
        assert json.load(f)["status"] == rec["status"]
    # no attention layer, no sequence in the cache: nothing to split
    rec = run_cell("xlstm-125m", "long_500k", out_dir=str(tmp_path),
                   verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")


def test_the_cli_writes_the_reference_keys(tmp_path):
    """``python -m repro_torch.launch.dryrun``'s ``main``, in this process:
    the decode cell that the plan's seq_shard_decode makes runnable."""
    main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--plan-json",
          '{"seq_shard_decode": true}', "--tag", "seq",
          "--out-dir", str(tmp_path)])
    with open(tmp_path / "pod16x16" / "llama3.2-1b__decode_32k__seq.json") as f:
        rec = json.load(f)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["plan"]["seq_shard_decode"] is True
    assert RECORD_KEYS <= set(rec)
    assert set(rec["memory"]) == {"argument", "output", "temp", "alias",
                                  "code"}
    assert {"compute_s", "memory_s", "collective_s", "bottleneck",
            "model_flops", "useful_flops_ratio"} <= set(rec["roofline"])
    assert rec["hlo"]["flops_amplification"] == 1.0
    assert rec["hlo"]["n_while_loops"] == 0
    assert rec["memory"]["alias"] > 0  # the cache, updated in place
