"""Counted collectives over process groups, and the autograd-aware ones
that the model's mesh path is written with.

The reference lets GSPMD insert its collectives; the port names each one,
so that they can be counted like the kernels' launches:
:func:`collective_counts` gives, by kind, the calls and the bytes of the
buffer each call reduces or gathers (the full tensor: an all-gather's
output, a reduce-scatter's input), since :func:`reset_collective_counts`.

Over a group, a CUDA tensor runs NCCL and a CPU tensor gloo; any other
pairing raises, so a mesh on the card never falls back to gloo or the CPU.
Inside a dry run (:class:`repro_torch.device.dry_run`) a meta tensor runs
the dry run's fake process group (``torch.distributed``'s ``fake``
backend, :func:`repro_torch.launch.mesh.init_fake_ranks`), which moves
nothing, and is counted like the tensor it stands for; a real tensor never
reaches a fake group, nor a meta one a real group.

The model's autograd-aware collectives (Megatron's f and g, FSDP's
gather, and what the MoE and the whole-computed mixers need):

* :func:`copy_to` — identity forward, all-reduce (sum) backward: the input
  of a column-parallel product, whose gradient each rank forms only in
  part.
* :func:`reduce_from` — all-reduce (sum) forward, identity backward: the
  output of a row-parallel product, or a sum of per-rank parts.
* :func:`gather_from` — all-gather along a dimension forward,
  reduce-scatter (sum) backward: a parameter sharded over data ranks
  (FSDP), gathered where it is used.
* :func:`gather_whole` — all-gather along a dimension forward, this rank's
  slice of the gradient backward: a parameter sharded over model ranks
  that every rank of the group uses whole, in the same computation, so
  that each forms the same whole gradient (the Mamba and xLSTM mixers).
* :func:`exchange` — an all-to-all forward, the same all-to-all of the
  gradient backward (expert parallelism: ``x[i]`` goes to rank i and
  rank i's part lands at ``out[i]``, a transposition over the ranks,
  which is its own adjoint).
* :func:`split_to` — this rank's slice along a dimension forward, the
  slices' gradients all-gathered backward: the adjoint of
  :func:`gather_whole`, for a computation that every rank of the group
  holds whole and each continues on its own slice of (the DP-only
  attention's batch reshard, an activation checkpoint cut along the
  sequence).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from ..device import in_dry_run

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "all_to_all",
           "all_reduce_coalesced", "all_gather_coalesced", "copy_to",
           "reduce_from", "gather_from", "gather_whole", "exchange",
           "split_to", "collective_counts", "reset_collective_counts"]

_COUNTS: Dict[str, Dict[str, int]] = {}


def collective_counts() -> Dict[str, Dict[str, int]]:
    """{kind: {"calls", "bytes"}} since the last reset; kinds
    ``all_reduce_sum``, ``all_reduce_max``, ``all_gather``,
    ``reduce_scatter``, ``all_to_all``."""
    return {k: dict(v) for k, v in _COUNTS.items()}


def reset_collective_counts() -> None:
    _COUNTS.clear()


def _count(kind: str, t: torch.Tensor) -> None:
    c = _COUNTS.setdefault(kind, {"calls": 0, "bytes": 0})
    c["calls"] += 1
    c["bytes"] += t.numel() * t.element_size()


def _check(t: torch.Tensor, group) -> None:
    backend = dist.get_backend(group)
    want = {"cuda": "nccl", "cpu": "gloo",
            "meta": "fake" if in_dry_run() else None}.get(t.device.type)
    if backend != want:
        raise RuntimeError(f"a collective over {t.device.type} tensors runs "
                           f"{want or 'nothing'}; the group runs {backend}")


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over ``group`` in place (``op``: sum or max); returns
    ``t``."""
    _check(t, group)
    _count(f"all_reduce_{op}", t)
    dist.all_reduce(t, op=_OPS[op], group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The shards of ``group``'s ranks concatenated along ``dim`` in rank
    order. The ranks' shards land stacked on a new leading dimension, which
    then moves to ``dim``: a view when ``dim`` is 0 or the group has one
    rank, else one copy of whole shard rows (no transposition)."""
    _check(t, group)
    n = dist.get_world_size(group)
    x = t.contiguous()
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    _count("all_gather", out)
    dist.all_gather_into_tensor(out.flatten(0, 1), x, group=group)
    shape = list(x.shape)
    shape[dim] *= n
    return out.movedim(0, dim).reshape(shape)


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``t`` summed over ``group`` and split along ``dim``: this rank's
    part. The parts are stacked on a new leading dimension first, which
    copies nothing when ``dim`` is 0 or the group has one rank."""
    _check(t, group)
    n = dist.get_world_size(group)
    shape = list(t.shape)
    if shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split over {n} ranks")
    x = t.reshape(shape[:dim] + [n, shape[dim] // n] + shape[dim + 1:]
                  ).movedim(dim, 0).contiguous()
    out = torch.empty(tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _count("reduce_scatter", x)
    dist.reduce_scatter_tensor(out, x.flatten(0, 1), group=group)
    return out


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (n, ...) over a group of n ranks: ``t[i]`` is sent to rank i,
    and row i of the result is what rank i sent this rank."""
    _check(t, group)
    n = dist.get_world_size(group)
    if t.shape[0] != n:
        raise ValueError(f"an all-to-all over {n} ranks takes a leading "
                         f"dimension of {n}, not {tuple(t.shape)}")
    x = t.contiguous()
    out = torch.empty_like(x)
    _count("all_to_all", x)
    dist.all_to_all_single(out, x, group=group)
    return out


#: the largest flat buffer a coalesced collective packs (bytes)
BUCKET_BYTES = 1 << 27


def _buckets(ts):
    """Runs of consecutive tensors of one dtype holding up to BUCKET_BYTES
    (a larger tensor is a run of its own), as lists of indices."""
    runs, size = [], 0
    for i, t in enumerate(ts):
        nbytes = t.numel() * t.element_size()
        if (not runs or t.dtype != ts[runs[-1][-1]].dtype
                or size + nbytes > BUCKET_BYTES):
            runs.append([])
            size = 0
        runs[-1].append(i)
        size += nbytes
    return runs


def all_reduce_coalesced(ts, group) -> None:
    """Sum each tensor of ``ts`` over ``group`` in place, packed into flat
    buffers (one all-reduce a buffer of up to BUCKET_BYTES)."""
    for run in _buckets(ts):
        flat = all_reduce(torch.cat([ts[i].reshape(-1) for i in run]), group)
        for i, part in zip(run, flat.split([ts[i].numel() for i in run])):
            ts[i].copy_(part.view_as(ts[i]))


def all_gather_coalesced(ts, dims, group) -> list:
    """``all_gather(ts[i], group, dims[i])`` for every i, packed into flat
    buffers (one all-gather a buffer of up to BUCKET_BYTES)."""
    n = dist.get_world_size(group)
    out = [None] * len(ts)
    for run in _buckets(ts):
        flat = all_gather(torch.cat([ts[i].reshape(-1) for i in run]),
                          group).view(n, -1)
        off = 0
        for i in run:
            t, d = ts[i], dims[i]
            part = flat[:, off:off + t.numel()].reshape((n,) + tuple(t.shape))
            shape = list(t.shape)
            shape[d] *= n
            out[i] = part.movedim(0, d).reshape(shape)
            off += t.numel()
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.width, ctx.width), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"split over {n} ranks")
        w = x.shape[dim] // n
        return x.narrow(dim, dist.get_rank(group) * w, w)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the gradient is summed over ``group``."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; the gradient passes through."""
    return _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x``'s shards over ``group`` concatenated along ``dim``; the
    gradient is summed over ``group`` and split back."""
    return _GatherFrom.apply(x, group, dim)


def gather_whole(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x``'s shards over ``group`` concatenated along ``dim``; the
    gradient, the same whole tensor on every rank of ``group``, is cut back
    to this rank's slice (no sum)."""
    return _GatherWhole.apply(x, group, dim)


def split_to(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (a view), ``x`` whole and
    alike on every rank of ``group``; the gradient, each rank's slice of
    it, is all-gathered back into the whole."""
    return _SplitTo.apply(x, group, dim)


def exchange(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_to_all` of ``x``; the gradient goes back by the same
    all-to-all."""
    return _Exchange.apply(x, group)
