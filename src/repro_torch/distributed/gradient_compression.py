"""Port of ``repro/distributed/gradient_compression.py``:
``init_error_state`` (:21) and ``compressed_psum`` (:32), int8 gradient
all-reduce with error feedback over a process group.

Each data rank adds its residual from the previous step to the fresh
gradient, quantizes each leaf to int8 with one scale shared by the group
(an all-reduce MAX of max |g| / 127 + 1e-30), all-reduces the int8 values
summed as int32, dequantizes and divides by the group's size, and keeps the
quantization error g − q·scale as the next step's residual: unbiased over
time, a quarter of float32's bytes on the wire (the sum travels as int32).
The arithmetic is the reference's, step for step, in float32. The trainer
runs it on the data axes' reduction of the gradients that are replicated
over data when ``plan.grad_compression`` is set; gradients summed over the
model axis are never compressed.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from .collectives import all_reduce, all_reduce_coalesced

__all__ = ["init_error_state", "compressed_psum"]


def _leaves(tree):
    """The leaves of a nested dict/list, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    """``fn`` over the leaves of ``tree`` in :func:`_leaves`' order."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def init_error_state(grads: Any) -> Any:
    """Zero float32 residuals laid out like ``grads``."""
    return _map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device), grads)


def compressed_psum(grads: Any, err: Any, group) -> Tuple[Any, Any]:
    """Over the ranks of ``group``: returns (mean gradient, new error
    residual), both float32 and laid out like ``grads``. The int8 payload is
    summed in int32 (safe up to 2^24 ranks). Each leaf has its own scale;
    the scales travel in one all-reduce MAX and the payloads in one
    all-reduce (packed, ``all_reduce_coalesced``)."""
    n = dist.get_world_size(group)
    g32 = [g.float() + e for g, e in zip(_leaves(grads), _leaves(err))]
    # shared scale across ranks (one MAX) → exact dequant grid
    scales = all_reduce(torch.stack([g.abs().max() for g in g32]), group,
                        "max") / 127.0 + 1e-30
    qs = [torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
          for g, s in zip(g32, scales)]
    totals = [q.to(torch.int32) for q in qs]
    all_reduce_coalesced(totals, group)
    out = [(t.float() * s / n, g - q.float() * s)
           for t, s, g, q in zip(totals, scales, g32, qs)]
    means, residuals = iter([m for m, _ in out]), iter([r for _, r in out])
    return (_map(lambda _: next(means), grads),
            _map(lambda _: next(residuals), grads))
