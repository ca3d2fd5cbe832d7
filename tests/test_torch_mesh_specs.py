"""The port's spec functions (``repro_torch.distributed.sharding``)
against the reference's ``PartitionSpec``\\ s, leaf for leaf, with no
ranks: ``param_specs`` for the six ported smoke configs and llama3.2-1b at
full width (its shapes from ``jax.eval_shape``, no arrays), at model widths
1, 2, 4 and 16, with ``fsdp_params`` off and on and with ``pure_dp``, over
('data',) and ('pod', 'data'); ``opt_state_spec_for`` on every leaf; and
``batch_specs``; and ``param_specs`` of the four archs with MoE, Mamba or
xLSTM layers (smoke configs, and jamba at full width) under both
``moe_impl``\ s. The reference's specs over stacked layer groups carry a
leading ``None``, which the port, with a list of layers, drops."""
import types

import jax
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import get_smoke_config as ref_smoke_config  # noqa: E402
from repro.distributed.sharding import \
    ExecutionPlan as RefPlan  # noqa: E402
from repro.distributed.sharding import \
    batch_specs as ref_batch_specs  # noqa: E402
from repro.distributed.sharding import \
    opt_state_spec_for as ref_opt_spec  # noqa: E402
from repro.distributed.sharding import \
    param_specs as ref_param_specs  # noqa: E402
from repro.launch.mesh import mesh_axes as ref_mesh_axes  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro.models.config import ShapeSpec as RefShapeSpec  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed.sharding import (ExecutionPlan,  # noqa: E402
                                              batch_specs, kv_whole_specs,
                                              opt_state_spec_for,
                                              param_specs)
from repro_torch.distributed.meshctx import (MeshContext,  # noqa: E402
                                             get_mesh_context, mesh_context)
from repro_torch.launch.mesh import mesh_axes  # noqa: E402
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402

PORTED = ["codeqwen1.5-7b", "starcoder2-7b", "qwen3-1.7b", "llama3.2-1b",
          "qwen2-vl-2b", "musicgen-large"]
CONFIGS = [(n, True) for n in PORTED] + [("llama3.2-1b", False)]
PLANS = {"default": {}, "fsdp": dict(fsdp_params=True),
         "pure_dp": dict(pure_dp=True, fsdp_params=True)}
AXES = {"single_pod": ("data",), "multi_pod": ("pod", "data")}


def _unstacked(cfg, tree):
    """The reference's tree (groups stacked) in the port's layout: one
    entry per layer, ``fn(leaf)`` of each group leaf."""
    out = {k: v for k, v in tree.items() if k != "groups"}
    out["layers"] = [tree["groups"][f"s{j}"] for g in range(cfg.num_groups)
                     for j in range(cfg.pattern_period)]
    return out


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def shapes():
    out = {}
    for name, smoke in CONFIGS:
        rcfg = (ref_smoke_config if smoke else ref_config)(name)
        cfg = (get_smoke_config if smoke else get_config)(name)
        ref = jax.eval_shape(lambda: ref_init_params(rcfg,
                                                     jax.random.PRNGKey(0)))
        out[name, smoke] = rcfg, cfg, ref, init_params(cfg, None)
    return out


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("name,smoke", CONFIGS,
                         ids=[f"{n}{'' if s else '-full'}" for n, s in CONFIGS])
def test_param_and_opt_specs_match_the_reference(shapes, name, smoke, plan):
    rcfg, cfg, ref, port = shapes[name, smoke]
    kinds = set()
    for axes_name, data_axes in AXES.items():
        for n_model in (1, 2, 4, 16):
            sizes = dict(pod=2, data=2, model=n_model)
            mesh = types.SimpleNamespace(shape=sizes)
            kw = dict(model_axis="model", data_axes=data_axes,
                      n_model=n_model)
            want = _unstacked(rcfg, ref_param_specs(
                ref, rcfg, RefPlan(**PLANS[plan]), **kw))
            got = param_specs(port, cfg, ExecutionPlan(**PLANS[plan]), **kw)
            wl, gl = list(_leaves(want)), list(_leaves(got))
            pl = dict(_leaves(port))
            assert [p for p, _ in wl] == [p for p, _ in gl] == list(pl)
            for (path, w), (_, g) in zip(wl, gl):
                w = tuple(w)
                if path[0] == "layers":
                    assert w[0] is None
                    w = w[1:]
                assert g == w, (path, g, w)
                kinds.add(g)
                shape = tuple(pl[path].shape)
                o = opt_state_spec_for(g, shape, data_axes, sizes)
                assert o == tuple(ref_opt_spec(jax.sharding.PartitionSpec(
                    *w), shape, data_axes, mesh)), (path, o)
            # the port's layout: whole kv projections where the kv heads
            # do not tile the model axis but are otherwise the specs
            laid = dict(_leaves(kv_whole_specs(got, cfg, "model", n_model)))
            for path, g in gl:
                kv = path[-1] in ("wk", "wv")
                if kv and cfg.num_kv_heads % n_model:
                    assert laid[path] == tuple(None if e == "model" else e
                                               for e in g)
                else:
                    assert laid[path] == g
    assert len(kinds) > 1


MIXERS = [("jamba-v0.1-52b", True), ("phi3.5-moe-42b-a6.6b", True),
          ("moonshot-v1-16b-a3b", True), ("xlstm-125m", True),
          ("jamba-v0.1-52b", False)]


@pytest.mark.parametrize("name,smoke", MIXERS,
                         ids=[f"{n}{'' if s else '-full'}" for n, s in MIXERS])
def test_mixer_param_specs_match_the_reference(name, smoke):
    """The MoE (3-D expert leaves, the router), Mamba and xLSTM leaves, leaf
    for leaf, with ``fsdp_params`` off and on, under ``tp_ragged`` and
    ``ep``, at model widths 1, 2, 4 and 16, over ('data',) and ('pod',
    'data'); and their optimizer specs."""
    rcfg = (ref_smoke_config if smoke else ref_config)(name)
    cfg = (get_smoke_config if smoke else get_config)(name)
    ref = jax.eval_shape(lambda: ref_init_params(rcfg, jax.random.PRNGKey(0)))
    port = init_params(cfg, None)
    pl = dict(_leaves(port))
    names = set()
    for knobs in ({}, dict(fsdp_params=True), dict(moe_impl="ep"),
                  dict(moe_impl="ep", fsdp_params=True)):
        for data_axes in AXES.values():
            for n_model in (1, 2, 4, 16):
                sizes = dict(pod=2, data=2, model=n_model)
                kw = dict(model_axis="model", data_axes=data_axes,
                          n_model=n_model)
                want = list(_leaves(_unstacked(rcfg, ref_param_specs(
                    ref, rcfg, RefPlan(**knobs), **kw))))
                got = list(_leaves(param_specs(port, cfg,
                                               ExecutionPlan(**knobs), **kw)))
                assert [p for p, _ in want] == [p for p, _ in got] == list(pl)
                for (path, w), (_, g) in zip(want, got):
                    w = tuple(w)
                    if path[0] == "layers":
                        assert w[0] is None
                        w = w[1:]
                    assert g == w, (path, g, w)
                    names.add(path[-1])
                    shape = tuple(pl[path].shape)
                    o = opt_state_spec_for(g, shape, data_axes, sizes)
                    assert o == tuple(ref_opt_spec(
                        jax.sharding.PartitionSpec(*w), shape, data_axes,
                        types.SimpleNamespace(shape=sizes))), (path, o)
    kinds = {"jamba": {"router", "in_proj", "x_proj", "dt_proj", "conv_w",
                       "conv_b", "dt_bias", "a_log", "d_skip", "out_proj"},
             "xlstm": {"up_proj", "q_proj", "k_proj", "v_proj", "i_gate",
                       "f_gate", "gn_scale", "w_izfo", "up_w", "down_w"}}
    assert kinds.get(name.split("-")[0], {"router", "wg", "wu", "wd"}) <= names


@pytest.mark.parametrize("name", PORTED)
def test_batch_specs_match_the_reference(name):
    rcfg, cfg = ref_smoke_config(name), get_smoke_config(name)
    for kind in ("train", "prefill", "decode"):
        for data_axes in AXES.values():
            want = ref_batch_specs(rcfg, RefShapeSpec("t", 32, 4, kind),
                                   data_axes)
            got = batch_specs(cfg, ShapeSpec("t", 32, 4, kind), data_axes)
            assert set(got) == set(want)
            for k in want:
                assert got[k] == tuple(want[k]), (k, got[k], want[k])


def test_mesh_axes_and_the_mesh_context():
    """``mesh_axes`` as the reference's; no mesh by default, and
    ``mesh_context`` installs a context and restores the previous one."""
    for multi_pod in (False, True):
        assert mesh_axes(multi_pod) == ref_mesh_axes(multi_pod)
    assert get_mesh_context().mesh is None
    outer = MeshContext(mesh=None, data_axes=("pod", "data"))
    with mesh_context(outer) as ctx:
        assert get_mesh_context() is ctx is outer
        inner = MeshContext(mesh=None)
        with mesh_context(inner):
            assert get_mesh_context() is inner
            assert inner.data_axes == ("data",)
            assert inner.model_axis == "model" and inner.specs is None
        assert get_mesh_context() is outer
    assert get_mesh_context().mesh is None
