"""Port of ``repro/models/moe.py``: ``init_moe_params`` (:33), the
capacity-buffer expert FFN ``_local_moe`` (:45), its expert-parallel
variant ``_local_moe_ep`` (:93), ``_dense_all_experts`` (:137) and
``moe_ffn`` (:159) with its rule for choosing between them (:172-182) and
its mesh branches (:184-208). Every path is differentiable: training runs
autograd through them.

``_local_moe`` is not dropless, whatever the reference's module docstring
says: each token's k routed slots are placed, in slot order, at the next
free row of their expert's buffer of ``cap = int(cf·T·k/E) + 1`` rows,
and a slot past the last row adds nothing. The reference scatters every
slot (a dropped one as zeros, at row ``cap - 1``); here a dropped slot is
written to a spare row past the buffers, which is then cut off, so no
buffer row is summed into and the spare row's gradient reaches nothing. A
dropped slot's gate is 0, so its gradient is 0, as in the reference's
``jnp.where(keep, …, 0)``. Each token's k expert outputs are added in slot
order, in the model dtype, as the reference's scatter-add adds them; an
atomic ``index_add_`` would add them in an order that changes run to run
in bf16. The reference's einsums are batched matrix products here, the
experts' weights read once per product. The gradient reaches the router
through the renormalised top-k gates and through the mean probabilities of
the aux loss.

Over a training mesh (``mesh``: a :class:`MoeMesh`, the model's view of
it), where the reference wraps the layer in ``shard_map`` over the data
axes:

* **The branch** is chosen on the global token count, ``B_loc · n_data ·
  S``, which is what GSPMD sees.
* **The dense branch** (below ``max(4 · n_data, 512)`` tokens) runs every
  expert on this rank's tokens with ``F`` split over the model axis, the
  parameters' layout, and sums the partial outputs over the model group.
  Its aux takes the experts' shares over the global batch, as GSPMD does
  (the counts all-reduced over the data ranks); the mean router
  probabilities stay the rank's, since the aux is linear in them.
* **``tp_ragged`` (expert-TP)**: ``_local_moe`` on the rank's tokens, with
  ``F`` split over the model axis, ``cap`` from the local token count at
  the fixed factor 1.25, the partial outputs summed over the model group.
* **``ep``**: ``_local_moe_ep``: the experts split over the model axis
  (this rank's ``E / n`` experts at their whole ``F``, which the model
  reshards from the expert-TP layout by one all-to-all over the model
  axis: GSPMD's reshard to ``P(model, None, None)``), ``cap`` from the
  local token count at ``cfg.capacity_factor``, the capacity buffers
  exchanged by two all-to-alls. Every model rank holds
  the same tokens and sends the same buffers, as in the reference; the
  gradient of the exchanged outputs is divided by the model width and the
  buffer's input gradient summed over the model group, so that the experts
  and the tokens get the gradient of one copy.
* **The aux** of both capacity branches is this rank's own; the reference's
  ``pmean`` over the data axes is the trainer's mean of the ranks' losses,
  whose gradient is the mean of their gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import collectives as C
from .config import ModelConfig
from .layers import init_dense

__all__ = ["init_moe_params", "moe_ffn", "MoeMesh"]

#: below this many tokens (the reference's ``max(4 · n_data, 512)`` with
#: ``n_data`` 1) every expert runs densely on every token
DENSE_TOKENS = 512
#: the capacity path's buffer rows per expert, over the mean k·T/E, of the
#: path without a mesh and of ``tp_ragged`` (the reference's default,
#: which neither overrides); ``ep`` reads ``cfg.capacity_factor``
CAPACITY_FACTOR = 1.25


@dataclasses.dataclass(frozen=True)
class MoeMesh:
    """What the MoE layer needs of a training mesh: the model group (``None``
    without a model axis) and its width, and the group over the data axes
    and their width (``None`` and 1 when every data rank holds the same
    tokens, as a served batch that does not tile the data axes)."""
    model_group: Optional[object]
    n_model: int
    data_group: Optional[object]
    n_data: int


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


def _aux(gates: torch.Tensor, eflat: torch.Tensor, num_experts: int,
         mesh: Optional[MoeMesh] = None) -> torch.Tensor:
    """Switch-style load-balance loss: E · Σ_e (mean router probability) ·
    (share of the routed slots). With ``mesh`` (the dense branch over a
    mesh) the shares are over the data ranks' tokens together; the mean
    probabilities stay this rank's: the aux is linear in them, so the mean
    over the data ranks (the trainer's) is the global batch's aux, and so
    is its gradient."""
    me = gates.mean(dim=0)
    # counted as a one-hot sum: bincount on the card reads its input's
    # maximum back to the host, a sync in every MoE layer of every step
    counts = F.one_hot(eflat, num_experts).sum(dim=0).float()
    slots = eflat.numel()
    if mesh is not None and mesh.data_group is not None:
        counts = C.all_reduce(counts, mesh.data_group)
        slots *= mesh.n_data
    return num_experts * (me * (counts / slots)).sum()


def _expert_ffn(buf, wg, wu, wd):
    """The gated expert FFN on each expert's rows: buf (E, R, D) → (E, R,
    D), SiLU in float32, products in the weights' dtype."""
    h = F.silu(torch.bmm(buf, wg).float()).to(buf.dtype) * torch.bmm(buf, wu)
    return torch.bmm(h, wd)


def _slots(x, router, k: int, num_experts: int, cf: float):
    """The routing of the capacity paths: (gates, the renormalised top-k
    gates in x's dtype (T, k), each slot's expert (T·k,), its row in the
    flat (E·cap, D) buffers, whether it fits, cap)."""
    t = x.shape[0]
    gates, topg, topi = _route(x, router, k)
    topg = (topg / topg.sum(-1, keepdim=True)).to(x.dtype)
    eflat = topi.reshape(-1)                                  # (T·k,)
    cap = int(cf * t * k / num_experts) + 1
    onehot = F.one_hot(eflat, num_experts)
    # each slot's row in its expert's buffer: the slots before it, in slot
    # order, routed to the same expert
    pos = (torch.cumsum(onehot, dim=0) - onehot).gather(1, eflat[:, None])[:, 0]
    keep = pos < cap
    row = eflat * cap + pos.clamp(max=cap - 1)
    return gates, topg, eflat, row, keep, cap


def _dispatch(x, row, keep, k: int, rows: int):
    """The flat capacity buffers (rows, D): each kept slot's token at its
    row; the dropped slots go to a spare row, cut off here."""
    buf = x.new_zeros((rows + 1, x.shape[1]))
    buf[torch.where(keep, row, rows)] = x.repeat_interleave(k, dim=0)
    return buf[:-1]


def _collect(out, row, keep, topg, t: int, k: int):
    """(T, D): each token's kept slots' rows of ``out`` (E·cap, D) times
    their gates, added in slot order; a dropped slot's gate is 0."""
    d = out.shape[-1]
    g = torch.where(keep, topg.reshape(-1),
                    torch.zeros((), dtype=topg.dtype, device=topg.device))
    return _combine((out[row] * g[:, None]).view(t, k, d))


def _local_moe(x, router, wg, wu, wd, *, k: int, num_experts: int,
               capacity_factor: float = CAPACITY_FACTOR,
               model_group=None):
    """x (T, D) → (y (T, D), aux): the capacity-buffer path. With
    ``model_group`` (expert-TP) ``wg``/``wu``/``wd`` hold this rank's
    slice of ``F`` and the partial outputs are summed over the group."""
    t, d = x.shape
    gates, topg, eflat, row, keep, cap = _slots(x, router, k, num_experts,
                                                capacity_factor)
    if model_group is not None:
        # the rank forms only its part of these inputs' gradients
        x, topg = C.copy_to(x, model_group), C.copy_to(topg, model_group)
    buf = _dispatch(x, row, keep, k, num_experts * cap)
    out = _expert_ffn(buf.view(num_experts, cap, d), wg, wu, wd)
    y = _collect(out.view(-1, d), row, keep, topg, t, k)
    if model_group is not None:
        y = C.reduce_from(y, model_group)
    return y, _aux(gates, eflat, num_experts)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _local_moe_ep(x, router, wg, wu, wd, *, k: int, num_experts: int,
                  capacity_factor: float, mesh: MoeMesh):
    """x (T, D) → (y, aux): experts split over the model group, this rank's
    ``E / n`` in ``wg``/``wu`` (E_loc, D, F) and ``wd`` (E_loc, F, D); the
    capacity buffers (n, E_loc, cap, D) go to their experts' ranks by an
    all-to-all and the outputs come back by another."""
    t, d = x.shape
    n, grp = mesh.n_model, mesh.model_group
    e_loc = num_experts // n
    gates, topg, eflat, row, keep, cap = _slots(x, router, k, num_experts,
                                                capacity_factor)
    # every model rank sends the same buffers: the gradient of one copy
    buf = _dispatch(C.copy_to(x, grp), row, keep, k, num_experts * cap)
    recv = C.exchange(buf.view(n, e_loc, cap, d), grp)       # (S, E_loc, ...)
    h = recv.transpose(0, 1).reshape(e_loc, n * cap, d)
    out = _expert_ffn(h, wg, wu, wd).view(e_loc, n, cap, d).transpose(0, 1)
    back = _ScaleGrad.apply(C.exchange(out, grp), 1.0 / n)
    y = _collect(back.reshape(num_experts * cap, d), row, keep, topg, t, k)
    return y, _aux(gates, eflat, num_experts)


def _combine(ys: torch.Tensor) -> torch.Tensor:
    """(T, k, D) → (T, D): the k slots of each token added in slot order,
    each sum rounded to the dtype."""
    y = ys[:, 0]
    for j in range(1, ys.shape[1]):
        y = y + ys[:, j]
    return y


def _dense_all_experts(x, router, wg, wu, wd, *, k: int, num_experts: int,
                       mesh: Optional[MoeMesh] = None):
    """x (T, D) → (y, aux): every expert on every token, combined with the
    renormalised top-k gates (the decode path). With ``mesh``, ``F`` is
    split over its model group and the aux is the global batch's."""
    t, d = x.shape
    gates, topg, topi = _route(x, router, k)
    topg = (topg / topg.sum(-1, keepdim=True)).to(x.dtype)
    grp = None if mesh is None else mesh.model_group
    if grp is not None:
        x, topg = C.copy_to(x, grp), C.copy_to(topg, grp)
    ye = _expert_ffn(x.unsqueeze(0).expand(num_experts, t, d), wg, wu, wd)
    w = torch.zeros((t, num_experts), dtype=x.dtype, device=x.device)
    w = w.scatter(1, topi, topg)
    # Σ_e ye[e, t] · w[t, e] as a product, summed in float32
    y = torch.bmm(ye.permute(1, 2, 0), w[:, :, None])[..., 0]
    if grp is not None:
        y = C.reduce_from(y, grp)
    return y, _aux(gates, topi.reshape(-1), num_experts, mesh)


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor,
            cfg: ModelConfig, mesh: Optional[MoeMesh] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (y (B, S, D), the float32 aux loss). Fewer than
    ``max(4 · n_data, 512)`` tokens in the global batch run every expert
    densely, more the capacity path (over a mesh, ``cfg.moe_impl``'s). Over
    a mesh ``params`` holds the leaves as the branch takes them: ``F`` split
    over the model axis, or this rank's experts for ``ep``'s capacity
    path."""
    b, s, d = x.shape
    k, e = cfg.experts_per_token, cfg.num_experts
    xf = x.reshape(b * s, d)
    w = (params["router"], params["wg"], params["wu"], params["wd"])
    if dense_branch(b * s, mesh):
        y, aux = _dense_all_experts(xf, *w, k=k, num_experts=e, mesh=mesh)
    elif mesh is not None and cfg.moe_impl == "ep":
        y, aux = _local_moe_ep(xf, *w, k=k, num_experts=e,
                               capacity_factor=cfg.capacity_factor,
                               mesh=mesh)
    else:
        y, aux = _local_moe(xf, *w, k=k, num_experts=e, model_group=(
            None if mesh is None else mesh.model_group))
    return y.reshape(b, s, d), aux


def dense_branch(tokens: int, mesh: Optional[MoeMesh] = None) -> bool:
    """Whether a layer over ``tokens`` of this rank's tokens runs every
    expert densely: the reference's rule on the global batch."""
    n_data = 1 if mesh is None else mesh.n_data
    return tokens * n_data < max(4 * n_data, DENSE_TOKENS)
