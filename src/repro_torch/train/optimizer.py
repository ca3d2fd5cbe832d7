"""Port of ``repro/train/optimizer.py``: :class:`AdamWConfig` (:19),
``init_opt_state`` (:28), ``global_norm`` (:39), ``clip_by_global_norm``
(:45) and ``adamw_update`` (:54), AdamW with float32 master weights.

The state mirrors the parameters' layout (the port's nested dict of
layers): per leaf a float32 ``master``, ``m`` and ``v``, plus a 0-d int32
``count``. The parameters themselves stay in the model's dtype. The
reference's state is immutable and ``adamw_update`` returns new trees; here
it updates ``m``, ``v``, ``master`` and ``count`` in place and writes the
new values into the parameter tensors, so a step holds no second copy of
the state (about 20 GB at llama3.2-1b), and returns the same objects. The
arithmetic is the reference's, in float32: the global-norm clip scale
folded into each leaf's update, the bias corrections in float32, and
weight decay on every leaf, norms included. A leaf of more than
:data:`SLICE_ELEMENTS` elements is updated in slices along its first
dimension (an expert, or a run of rows), each slice's float32
temporaries freed before the next: the values are the same, elementwise,
and a (16, 4,096, 14,336) expert leaf then needs ~0.24 GB of temporaries
instead of ~3.8 GB for each.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch

#: leaves larger than this are updated in slices along their first dimension
SLICE_ELEMENTS = 1 << 26

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update",
           "global_norm", "clip_by_global_norm", "tree_leaves", "tree_map"]


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nested dict/list, dict keys in sorted order (the
    order ``jax.tree_util`` flattens a dict in)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and of the trees in ``rest``,
    laid out alike), keeping the containers."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def init_opt_state(params: Any) -> Dict[str, Any]:
    """Float32 copies of the parameters (``master``), zero ``m`` and ``v``
    of the same shapes, on the parameters' devices, and ``count`` 0."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return dict(
        master=tree_map(lambda p: p.detach().float().clone(), params),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree: Any) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), each leaf squared in float32."""
    total = sum(torch.sum(torch.square(x.float()))
                for x in tree_leaves(tree))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """The gradients in float32 scaled by min(1, max_norm / (norm +
    1e-12)), and the norm."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def adamw_update(grads: Any, opt_state: Dict[str, Any], params: Any,
                 ocfg: AdamWConfig, lr_scale, gnorm=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step. ``grads`` is laid out like ``params``; ``lr_scale``
    a number or a 0-d tensor. Updates ``opt_state`` and the parameter
    tensors in place and returns (params, opt_state, {"grad_norm"}): the
    new parameters are the new master weights cast to each parameter's
    dtype. ``gnorm``: the gradient's global norm where ``grads`` is a
    shard of it (the trainer over a mesh), else ``global_norm(grads)``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    clip_scale = torch.clamp(ocfg.grad_clip / (gnorm + 1e-12), max=1.0)
    count = opt_state["count"] + 1
    countf = count.float()
    b1, b2 = (torch.tensor(x, dtype=torch.float32, device=countf.device)
              for x in (ocfg.b1, ocfg.b2))
    b1c = 1.0 - b1 ** countf
    b2c = 1.0 - b2 ** countf
    lr = ocfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                   device=countf.device)
    flat = zip(tree_leaves(grads), tree_leaves(opt_state["m"]),
               tree_leaves(opt_state["v"]), tree_leaves(opt_state["master"]),
               tree_leaves(params))
    for leaf in flat:
        for g, m, v, w, p in _slices(*leaf):
            g = g.float() * clip_scale
            m.mul_(ocfg.b1).add_((1 - ocfg.b1) * g)
            v.mul_(ocfg.b2).add_((1 - ocfg.b2) * g * g)
            step = (m / b1c) / (torch.sqrt(v / b2c) + ocfg.eps)
            w.sub_(lr * (step + ocfg.weight_decay * w))
            p.copy_(w)
    opt_state["count"] = count
    return params, opt_state, dict(grad_norm=gnorm)


def _slices(*ts):
    """Matching slices of same-shaped tensors along dimension 0, each of
    at most :data:`SLICE_ELEMENTS` elements where a row allows (views, so
    the in-place updates land in the tensors); the tensors themselves when
    they are small."""
    t0 = ts[0]
    if t0.numel() <= SLICE_ELEMENTS or t0.dim() == 0 or t0.shape[0] == 1:
        return [ts]
    rows = max(1, SLICE_ELEMENTS // max(1, t0.numel() // t0.shape[0]))
    return [tuple(t[i:i + rows] for t in ts)
            for i in range(0, t0.shape[0], rows)]
