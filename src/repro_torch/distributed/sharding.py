"""Port of ``repro/distributed/sharding.py``: :class:`ExecutionPlan` (:34)
with its ``apply`` (:64), and the spec functions that lay parameters,
optimizer state, batches and caches over a mesh: ``_rule`` (:72),
``param_specs`` (:114), ``opt_state_spec_for`` (:143), ``batch_specs``
(:172), ``cache_specs`` (:187) and ``to_shardings`` (:233).

Layout (mesh axes: optional 'pod', 'data', 'model'):

* batch dims → the data axes (DP);
* attention heads, FFN hidden, vocab → 'model' (TP);
* optimizer state → additionally sharded over the data axes (ZeRO);
* parameters → replicated over 'data' by default; ``plan.fsdp_params``
  shards them over 'data' too (FSDP), for an all-gather per use;
* KV caches → batch over 'data' when the batch tiles it, else the sequence
  over 'data' (sequence parallelism for a batch of 1); kv heads over
  'model' when they tile it, else the sequence over 'model' too.

A spec is a tuple with one entry per dimension: ``None``, an axis name, or
a tuple of axis names, as the entries of the reference's
``PartitionSpec``. :func:`param_specs` maps the port's parameter tree (a
dict with a list of per-layer dicts) to such tuples, and its specs equal the
reference's leaf for leaf; the reference's leading ``None`` over stacked
layer groups drops, since the port keeps a list of layers. :func:`to_shardings`
turns specs into :class:`Sharding`\\ s, which cut a logical tensor into
this rank's shard and gather it back. :func:`kv_whole_specs` is the one
place the port lays a leaf out otherwise than its spec says: when the kv
heads do not tile the model axis but the q heads do, GSPMD splits ``wk`` and
``wv`` inside a head; the port keeps them whole on each model rank instead
(the values are the same). A dimension that does not divide over the
axes its spec names raises ``ValueError`` (GSPMD pads uneven shards; the
port does not).

``moe_impl`` picks the MoE layer's mesh branch (expert-TP ``tp_ragged``
or expert-parallel ``ep``, :mod:`repro_torch.models.moe`). The rules lay
the MoE, Mamba and xLSTM leaves out as the reference's do; the model
gathers a Mamba or xLSTM mixer's model-axis leaves and computes the mixer
whole on each model rank (a deliberate divergence, as
:func:`kv_whole_specs` is: the layout is the reference's, the values
GSPMD's).

:func:`cache_specs` gives the reference's cache specs for every slot
kind. The model lays attention's k/v out by them, and keeps a Mamba or
xLSTM state whole on every model rank where they split it over the model
axis, as it computes those mixers whole there (the divergence above).
``seq_shard_decode`` (read by :func:`decode_seq_axes_for`, the reference
dry run's decode rule) decodes from a sequence-sharded cache through
:func:`repro_torch.models.layers.sharded_decode_attention`; the serving
launcher always turns it on, as the port never gathers a cache. The knobs
``attn_batch_reshard``, ``shard_activation_ckpt`` and ``scan_layers``
wait for the dry run that sets them (ROADMAP §1, item 3.3): a knob is a
field once code reads it. The port loops over its layers, so
``scan_layers`` would change no value.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

from ..models.config import ModelConfig, ShapeSpec
from .collectives import all_gather
from .meshctx import MeshContext, _axes

__all__ = ["ExecutionPlan", "param_specs", "opt_state_spec_for",
           "batch_specs", "cache_specs", "decode_seq_axes_for", "to_shardings", "Sharding",
           "kv_whole_specs", "map_specs", "Spec"]

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Execution-strategy choices for one (arch × shape × mesh) cell."""
    fsdp_params: bool = False
    remat: str = "layer"            # none | layer
    moe_impl: str = "tp_ragged"     # tp_ragged | ep
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    grad_compression: bool = False  # int8 + error feedback on the DP axis
    # pure_dp: no tensor parallelism — the whole mesh is one flat DP/FSDP
    # domain (params ZeRO-3-sharded over every axis, batch over every axis)
    pure_dp: bool = False
    # decode over a sequence-sharded KV cache through
    # layers.sharded_decode_attention (batch-1 cells), never gathering it
    seq_shard_decode: bool = False

    def apply(self, cfg: ModelConfig) -> ModelConfig:
        return dataclasses.replace(
            cfg, remat=self.remat, moe_impl=self.moe_impl,
            attn_q_chunk=self.attn_q_chunk, attn_kv_chunk=self.attn_kv_chunk)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _rule(path: Tuple[str, ...], shape: Tuple[int, ...], tp, fsdp,
          attn_tp: bool = True) -> Spec:
    """Spec for one parameter leaf: the reference's rules (:72-111)."""
    name = path[-1]
    if "mlp" in path and name in ("wg", "wu", "wd") and len(shape) == 3:
        # (E, D, F) / (E, F, D): the expert-TP layout (F on model)
        return (None, fsdp, tp) if name != "wd" else (None, tp, fsdp)
    if name == "router":
        return (None, None)
    if name == "embed":
        return (tp, fsdp)
    if name == "lm_head":
        return (fsdp, tp)
    if name in ("wq", "wk", "wv"):
        # heads that don't tile the model axis: DP-only attention
        # (replicated q/k/v/o weights), as in the reference
        return (fsdp, tp) if attn_tp else (fsdp, None)
    if name == "wo":
        return (tp, fsdp) if attn_tp else (None, fsdp)
    if name in ("wg", "wu", "wi", "up_proj", "in_proj", "up_w", "w_izfo"):
        return (fsdp, tp)
    if name in ("wd", "out_proj", "down_w"):
        return (tp, fsdp)
    if name in ("x_proj", "a_log", "i_gate", "f_gate"):
        return (tp, None)
    if name in ("dt_proj", "q_proj", "k_proj", "v_proj", "conv_w"):
        return (None, tp)
    if name in ("conv_b", "dt_bias", "d_skip", "gn_scale") and len(shape) == 1:
        return (tp,)
    # norms, biases, small states: replicated
    return (None,) * len(shape)


def _map_path(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a tree of dicts and lists (a spec, a tuple,
    is a leaf)."""
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_specs(params: Dict[str, Any], cfg: ModelConfig,
                plan: ExecutionPlan, *, model_axis: str = "model",
                data_axes: Tuple[str, ...] = ("data",),
                n_model: int = 16) -> Dict[str, Any]:
    """The spec of every leaf of ``params`` (anything with a ``shape``,
    e.g. ``init_params(cfg, None)``'s meta tensors), laid out like it.
    ``n_model``: the model axis's width, which decides ``attn_tp``."""
    if plan.pure_dp:
        if cfg.num_experts:
            raise ValueError("pure_dp is for dense archs (experts need the "
                             "model axis)")
        fsdp = tuple(dict.fromkeys(tuple(data_axes) + (model_axis,)))
        tp = None
    else:
        fsdp = tuple(data_axes) if plan.fsdp_params else None
        tp = model_axis
    if fsdp is not None and len(fsdp) == 1:
        fsdp = fsdp[0]  # a one-axis entry is its name, as in PartitionSpec
    # TP on attention only when the q heads tile the model axis
    attn_tp = cfg.num_heads % n_model == 0
    return _map_path(lambda path, leaf: _rule(path, tuple(leaf.shape), tp,
                                              fsdp, attn_tp), params)


def kv_whole_specs(specs: Dict[str, Any], cfg: ModelConfig,
                   model_axis: str, n_model: int) -> Dict[str, Any]:
    """``specs`` with ``wk`` and ``wv`` whole over the model axis when the
    kv heads do not tile it (each model rank then takes the kv heads its q
    heads read); the layout the port gives such a model."""
    if cfg.num_kv_heads % n_model == 0:
        return specs
    return _map_path(
        lambda path, spec: tuple(None if e == model_axis else e
                                 for e in spec)
        if path[-1] in ("wk", "wv") else spec, specs)


def _sizes(mesh) -> Dict[str, int]:
    """Axis name → width of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))


def opt_state_spec_for(param_spec: Spec, shape: Tuple[int, ...],
                       data_axes: Tuple[str, ...], mesh) -> Spec:
    """ZeRO: additionally shard the optimizer moments / master weights over
    the data axes on the first divisible unsharded dim (skipping axes the
    param layout already uses, e.g. under pure_dp/FSDP). ``mesh``: a
    ``DeviceMesh`` or a mapping of axis widths."""
    sizes = _sizes(mesh)
    used = {ax for e in param_spec for ax in _axes(e)}
    free_axes = tuple(ax for ax in data_axes if ax not in used)
    if not free_axes:
        return tuple(param_spec)
    n_data = 1
    for ax in free_axes:
        n_data *= sizes[ax]
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % n_data == 0 and dim >= n_data:
            entries[i] = free_axes if len(free_axes) > 1 else free_axes[0]
            return tuple(entries)
    return tuple(param_spec)  # nothing divisible: keep the param layout


# ---------------------------------------------------------------------------
# Batch specs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: ShapeSpec,
                data_axes: Tuple[str, ...] = ("data",)) -> Dict[str, Spec]:
    da = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    specs: Dict[str, Spec] = {}
    if cfg.input_mode == "tokens":
        specs["tokens"] = (da, None)
    else:
        specs["embeds"] = (da, None, None)
        if cfg.mrope:
            specs["positions3"] = (None, da, None)
    if shape.kind == "train":
        specs["labels"] = (da, None)
    return specs


# ---------------------------------------------------------------------------
# Cache specs
# ---------------------------------------------------------------------------

def _batch_split(global_batch: int, n_data: int) -> bool:
    """Whether a batch is split over the data axes (else sequence
    parallelism takes them): the reference's rule."""
    return global_batch % n_data == 0 and global_batch >= n_data


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
                model_axis: str = "model",
                data_axes: Tuple[str, ...] = ("data",)) -> Dict[str, Any]:
    """Specs mirroring ``init_cache``'s tree (``{"pos", "layers"}``), the
    reference's (:187-229) leaf for leaf: the batch over the data axes when
    ``shape.global_batch`` tiles them, else the data axes on the sequence;
    attention's kv heads over the model axis when they tile it, else the
    model axis on the sequence too; a Mamba state's ``d_inner`` and an
    mLSTM's ``conv`` over the model axis. ``mesh``: a ``DeviceMesh`` or a
    mapping of axis widths."""
    sizes = _sizes(mesh)
    n_data = 1
    for ax in data_axes:
        n_data *= sizes[ax]
    n_model = sizes[model_axis]
    da = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    split = _batch_split(shape.global_batch, n_data)
    bspec = da if split else None
    seq_data = None if split else da
    heads_on_model = cfg.num_kv_heads % n_model == 0
    head_spec = model_axis if heads_on_model else None
    if heads_on_model:
        seq_spec = seq_data
    elif seq_data is None:
        seq_spec = model_axis
    else:  # both data (a batch of 1) and model on the sequence
        seq_spec = tuple(data_axes) + (model_axis,)

    def slot_spec(kind):
        if kind == "a":
            kv = (bspec, head_spec, seq_spec, None)
            return dict(k=kv, v=kv)
        if kind == "m":
            return dict(conv=(bspec, None, model_axis),
                        ssm=(bspec, model_axis, None))
        if kind == "M":
            return dict(C=(bspec, None, None, None), n=(bspec, None, None),
                        conv=(bspec, None, model_axis))
        return dict(c=(bspec, None), n=(bspec, None), h=(bspec, None),
                    m=(bspec, None))

    return dict(pos=(), layers=[slot_spec(cfg.layer_kind(i))
                                for i in range(cfg.num_layers)])


def decode_seq_axes_for(cfg: ModelConfig, shape: ShapeSpec, mesh,
                        plan: ExecutionPlan, *, model_axis: str = "model",
                        data_axes: Tuple[str, ...] = ("data",)
                        ) -> Optional[Tuple[str, ...]]:
    """``MeshContext.decode_seq_axes`` for a decode of ``shape`` under
    ``plan``, by the reference dry run's rule (``launch/dryrun.py``
    :116-128): with ``seq_shard_decode`` on and a batch that does not tile
    the data axes, the data axes, and the model axis too when the kv heads
    do not tile it; with a batch that tiles them, the model axis where the
    kv heads do not tile it (the cache's sequence is split over it, and
    the port never gathers a cache); else ``None``. With
    ``seq_shard_decode`` off, ``None`` where :func:`cache_specs` leaves the
    cache's sequence whole, and ``ValueError`` where it splits it: the
    reference then lets GSPMD gather the cache, which the port never does,
    so the serving launcher always turns the knob on."""
    sizes = _sizes(mesh)
    n_data = 1
    for ax in data_axes:
        n_data *= sizes[ax]
    if _batch_split(shape.global_batch, n_data):
        # the reference leaves this cache to GSPMD, which gathers a
        # sequence split over the model axis; the port decodes it sharded
        axes = (None if cfg.num_kv_heads % sizes[model_axis] == 0
                else (model_axis,))
    elif cfg.num_kv_heads % sizes[model_axis] == 0:
        axes = tuple(data_axes)
    else:
        axes = tuple(data_axes) + (model_axis,)
    if axes is not None and not plan.seq_shard_decode:
        raise ValueError(f"the cache's sequence is split over {axes} and "
                         f"seq_shard_decode is off: the port never gathers "
                         f"a cache")
    return axes


# ---------------------------------------------------------------------------
# Shardings: a spec on a mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh, as seen from this rank: :meth:`shard` cuts a
    logical tensor into this rank's shard, :meth:`gather` all-gathers the
    shards back into the logical tensor (a collective: every rank of the
    mesh calls it)."""
    ctx: MeshContext
    spec: Spec

    def _dims(self):
        return [(d, _axes(e)) for d, e in enumerate(self.spec) if e]

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``t`` (a view when nothing is cut)."""
        for d, axes in self._dims():
            n = self.ctx.size(axes)
            if t.shape[d] % n:
                raise ValueError(f"dimension {d} of {tuple(t.shape)} does "
                                 f"not split over {n} ranks of {axes}")
            w = t.shape[d] // n
            t = t.narrow(d, self.ctx.index(axes) * w, w)
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The logical tensor from this rank's shard ``t``."""
        for d, axes in self._dims():
            t = all_gather(t, self.ctx.group(axes), d)
        return t


def map_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a spec tree (dicts and lists; a spec, a
    tuple, is a leaf) and trees laid out like it."""
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_specs(fn, v, *(t[i] for t in trees))
                for i, v in enumerate(specs)]
    return fn(specs, *trees)


def to_shardings(tree_specs, mesh_or_ctx: Union[MeshContext, Any]):
    """``tree_specs`` with every spec turned into a :class:`Sharding` on
    the mesh (a ``DeviceMesh`` or a :class:`MeshContext`)."""
    ctx = (mesh_or_ctx if isinstance(mesh_or_ctx, MeshContext)
           else MeshContext(mesh_or_ctx))
    return map_specs(lambda spec: Sharding(ctx, tuple(spec)), tree_specs)
