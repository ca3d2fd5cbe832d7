"""Port of ``repro/models/moe.py`` for one device: ``init_moe_params``
(:33), the capacity-buffer expert FFN ``_local_moe`` (:45),
``_dense_all_experts`` (:137) and ``moe_ffn`` (:159) with its rule for
choosing between them (:172-182).

``_local_moe`` is not dropless, whatever the reference's module docstring
says: each token's k routed slots are placed, in slot order, at the next
free row of their expert's buffer of ``cap = int(1.25·T·k/E) + 1`` rows,
and a slot past the last row adds nothing. The reference scatters every
slot (a dropped one as zeros, at row ``cap - 1``); here a dropped slot is
written to a spare row past the buffers, which is then cut off, so no
buffer row is summed into. Each token's k expert outputs are added in slot
order, in the model dtype, as the reference's scatter-add adds them; an
atomic ``index_add_`` would add them in an order that changes run to run
in bf16. The reference's einsums are batched matrix products here, the
experts' weights read once per product.

Waiting for item 3.2b (ROADMAP §1): the mesh path (``shard_map`` over the
data axes, expert-TP's ``psum``), the expert-parallel all-to-all
``_local_moe_ep`` (:93) and the ``moe_impl`` knob that picks it; with no
mesh ``n_data`` is 1.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import init_dense

__all__ = ["init_moe_params", "moe_ffn"]

#: below this many tokens (the reference's ``max(4 · n_data, 512)`` with
#: ``n_data`` 1) every expert runs densely on every token
DENSE_TOKENS = 512
#: the capacity path's buffer rows per expert, over the mean k·T/E (the
#: reference's default, which its path without a mesh never overrides)
CAPACITY_FACTOR = 1.25


def init_moe_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                    dtype) -> Dict[str, torch.Tensor]:
    """The router (d, E) float32, N(0, 0.02²); ``wg``/``wu`` (E, d, f) and
    ``wd`` (E, f, d) in ``dtype``, N(0, 1/fan_in) with fan_in d and f."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return dict(
        router=init_dense(gen, (d, e), scale=0.02, dtype=torch.float32),
        wg=init_dense(gen, (e, d, f), scale=d ** -0.5, dtype=dtype),
        wu=init_dense(gen, (e, d, f), scale=d ** -0.5, dtype=dtype),
        wd=init_dense(gen, (e, f, d), scale=f ** -0.5, dtype=dtype),
    )


def _route(x: torch.Tensor, router: torch.Tensor, k: int):
    """The router's float32 probabilities (T, E) and each token's top k
    (descending) with their indices."""
    gates = torch.softmax(x.float() @ router, dim=-1)
    topg, topi = torch.topk(gates, k, dim=-1)
    return gates, topg, topi


def _aux(gates: torch.Tensor, eflat: torch.Tensor, num_experts: int
         ) -> torch.Tensor:
    """Switch-style load-balance loss: E · Σ_e (mean router probability) ·
    (share of the routed slots)."""
    me = gates.mean(dim=0)
    # counted as a one-hot sum: bincount on the card reads its input's
    # maximum back to the host, a sync in every MoE layer of every step
    ce = F.one_hot(eflat, num_experts).sum(dim=0).float() / eflat.numel()
    return num_experts * (me * ce).sum()


def _expert_ffn(buf, wg, wu, wd):
    """The gated expert FFN on each expert's rows: buf (E, R, D) → (E, R,
    D), SiLU in float32, products in the weights' dtype."""
    h = F.silu(torch.bmm(buf, wg).float()).to(buf.dtype) * torch.bmm(buf, wu)
    return torch.bmm(h, wd)


def _local_moe(x, router, wg, wu, wd, *, k: int, num_experts: int):
    """x (T, D) → (y (T, D), aux): the capacity-buffer path."""
    t, d = x.shape
    gates, topg, topi = _route(x, router, k)
    topg = (topg / topg.sum(-1, keepdim=True)).to(x.dtype)
    eflat = topi.reshape(-1)                                  # (T·k,)
    cap = int(CAPACITY_FACTOR * t * k / num_experts) + 1
    onehot = F.one_hot(eflat, num_experts)
    # each slot's row in its expert's buffer: the slots before it, in slot
    # order, routed to the same expert
    pos = (torch.cumsum(onehot, dim=0) - onehot).gather(1, eflat[:, None])[:, 0]
    keep = pos < cap
    row = eflat * cap + pos.clamp(max=cap - 1)
    buf = x.new_zeros((num_experts * cap + 1, d))
    buf[torch.where(keep, row, num_experts * cap)] = \
        x.repeat_interleave(k, dim=0)
    out = _expert_ffn(buf[:-1].view(num_experts, cap, d), wg, wu, wd)
    ys = out.view(-1, d)[row] * torch.where(
        keep, topg.reshape(-1), torch.zeros((), dtype=x.dtype,
                                            device=x.device))[:, None]
    return _combine(ys.view(t, k, d)), _aux(gates, eflat, num_experts)


def _combine(ys: torch.Tensor) -> torch.Tensor:
    """(T, k, D) → (T, D): the k slots of each token added in slot order,
    each sum rounded to the dtype."""
    y = ys[:, 0]
    for j in range(1, ys.shape[1]):
        y = y + ys[:, j]
    return y


def _dense_all_experts(x, router, wg, wu, wd, *, k: int, num_experts: int):
    """x (T, D) → (y, aux): every expert on every token, combined with the
    renormalised top-k gates (the decode path)."""
    t, d = x.shape
    gates, topg, topi = _route(x, router, k)
    topg = topg / topg.sum(-1, keepdim=True)
    ye = _expert_ffn(x.unsqueeze(0).expand(num_experts, t, d), wg, wu, wd)
    w = torch.zeros((t, num_experts), dtype=x.dtype, device=x.device)
    w.scatter_(1, topi, topg.to(x.dtype))
    # Σ_e ye[e, t] · w[t, e] as a product, summed in float32
    y = torch.bmm(ye.permute(1, 2, 0), w[:, :, None])[..., 0]
    return y, _aux(gates, topi.reshape(-1), num_experts)


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor,
            cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (y (B, S, D), the float32 aux loss). Fewer than
    :data:`DENSE_TOKENS` tokens run every expert densely, more the
    capacity path."""
    b, s, d = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    xf = x.reshape(b * s, d)
    fn = _dense_all_experts if b * s < DENSE_TOKENS else _local_moe
    y, aux = fn(xf, params["router"], params["wg"], params["wu"],
                params["wd"], k=k, num_experts=e)
    return y.reshape(b, s, d), aux
