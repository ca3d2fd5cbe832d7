"""Port of ``repro/distributed/sharding.py``: :class:`ExecutionPlan` (:34)
with its ``apply`` (:64), and the spec functions that lay parameters,
optimizer state and batches over a training mesh: ``_rule`` (:72),
``param_specs`` (:114), ``opt_state_spec_for`` (:143), ``batch_specs``
(:172) and ``to_shardings`` (:233).

Layout (mesh axes: optional 'pod', 'data', 'model'):

* batch dims → the data axes (DP);
* attention heads, FFN hidden, vocab → 'model' (TP);
* optimizer state → additionally sharded over the data axes (ZeRO);
* parameters → replicated over 'data' by default; ``plan.fsdp_params``
  shards them over 'data' too (FSDP), for an all-gather per use.

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

``cache_specs`` and the knobs ``attn_batch_reshard``,
``shard_activation_ckpt``, ``seq_shard_decode``, ``moe_impl`` and
``scan_layers`` wait for the code that reads them (ROADMAP §1, items
3.2b, 3.3 and 4): a knob is a field once code reads it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple, Union

import torch

from ..models.config import ModelConfig, ShapeSpec
from .collectives import all_gather
from .meshctx import MeshContext, _axes

__all__ = ["ExecutionPlan", "param_specs", "opt_state_spec_for",
           "batch_specs", "to_shardings", "Sharding", "kv_whole_specs",
           "map_specs", "Spec"]

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Execution-strategy choices for one (arch × shape × mesh) cell."""
    fsdp_params: bool = False
    remat: str = "layer"            # none | layer
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    grad_compression: bool = False  # int8 + error feedback on the DP axis
    # pure_dp: no tensor parallelism — the whole mesh is one flat DP/FSDP
    # domain (params ZeRO-3-sharded over every axis, batch over every axis)
    pure_dp: bool = False

    def apply(self, cfg: ModelConfig) -> ModelConfig:
        return dataclasses.replace(
            cfg, remat=self.remat, attn_q_chunk=self.attn_q_chunk,
            attn_kv_chunk=self.attn_kv_chunk)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _rule(path: Tuple[str, ...], shape: Tuple[int, ...], tp, fsdp,
          attn_tp: bool = True) -> Spec:
    """Spec for one parameter leaf (the reference's rules for the leaves
    the port builds: embeddings, attention, dense MLPs, norms)."""
    name = path[-1]
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
    if name in ("wg", "wu", "wi"):
        return (fsdp, tp)
    if name == "wd":
        return (tp, fsdp)
    # norms: replicated
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
