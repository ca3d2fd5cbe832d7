"""Counterpart of ``repro/launch/hlo_analysis.py`` (``analyze_hlo`` :146,
``HloStats`` :75): what one call computes, moves and holds, counted as it
runs.

There is no HLO in PyTorch. The reference parses the compiled module's
text and walks its call graph; the port runs the call eagerly under
:class:`OpCount`, a ``TorchDispatchMode`` that sees every aten operation
below autograd (the backward's and a checkpoint's recompute included), on
the card or on the dry run's meta tensors alike:

* ``dot_flops`` — 2·|result|·|contracted| per matrix product (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``addmv``, ``dot``: the tensor
  cores' term); a kernel of the port adds the work its wrapper reports
  (:func:`repro_torch.kernels._build.note_work`: ``flash_attention`` and
  ``flash_attention_bwd``, one op each, by PERF.md's bound for rows 10 and
  10b), the same whether the kernel ran or the dry run's shape rule did.
* ``dot_bytes`` — lhs + rhs + result bytes per product (a kernel: its
  operands and results), the reference's HBM-traffic proxy.
* ``touched_bytes`` — tensor operands + results of every operation that is
  not a view.
* ``collective_bytes`` and ``collective_counts`` — read from
  :func:`repro_torch.distributed.collectives.collective_counts` over the
  call, under the reference's kind names: ``all-reduce`` (its bytes
  counted twice, as the reference counts the ring's reduce and
  broadcast), ``all-gather`` (the output's bytes), ``reduce-scatter`` (the
  input's) and ``all-to-all``.
* The loop fields: eager code counts every layer as it runs, so there is
  no loop to correct for: ``flops_amplification`` and
  ``bytes_amplification`` are 1.0, ``n_while_loops`` and
  ``unknown_trip_loops`` 0.

:class:`OpCount` also follows the bytes of live storages: each operation
result that aliases no input is a new storage, counted until Python frees
it. ``peak_bytes`` is the most that were live at once, above what was
live when the count began (the call's arguments, held by the caller).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..distributed.collectives import collective_counts
from ..kernels._build import WORK_SINKS

__all__ = ["OpCount", "OpStats", "tensor_bytes"]

_aten = torch.ops.aten
#: the matrix products, each with the index of its left operand
_DOTS = {_aten.mm.default: 0, _aten.bmm.default: 0, _aten.mv.default: 0,
         _aten.dot.default: 0, _aten.addmm.default: 1,
         _aten.baddbmm.default: 1, _aten.addmv.default: 1}
#: the port's collective kinds → the reference's, with the factor on bytes
_KINDS = {"all_reduce_sum": ("all-reduce", 2.0),
          "all_reduce_max": ("all-reduce", 2.0),
          "all_gather": ("all-gather", 1.0),
          "reduce_scatter": ("reduce-scatter", 1.0),
          "all_to_all": ("all-to-all", 1.0)}


def tensor_bytes(tree) -> int:
    """The bytes of every tensor in a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


@dataclasses.dataclass
class OpStats:
    """The reference's ``HloStats``, field for field."""
    dot_flops: float
    dot_bytes: float
    collective_bytes: Dict[str, float]
    collective_counts: Dict[str, float]
    touched_bytes: float
    flops_amplification: float = 1.0
    bytes_amplification: float = 1.0
    n_while_loops: int = 0
    unknown_trip_loops: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def to_json(self) -> dict:
        return dict(dot_flops=self.dot_flops,
                    dot_bytes=self.dot_bytes,
                    collective_bytes=dict(self.collective_bytes),
                    collective_counts=dict(self.collective_counts),
                    total_collective_bytes=self.total_collective_bytes,
                    touched_bytes=self.touched_bytes,
                    flops_amplification=self.flops_amplification,
                    bytes_amplification=self.bytes_amplification,
                    n_while_loops=self.n_while_loops,
                    unknown_trip_loops=self.unknown_trip_loops)


class OpCount(TorchDispatchMode):
    """``with OpCount() as oc: fn(...)``, then ``oc.stats()`` and
    ``oc.peak_bytes`` (module docstring). ``kernel_calls``: the calls of
    each kernel wrapper that reported its work; ``devices``: the device
    types of every operation's tensors (a dry run's are ``meta`` only),
    each with the first operation seen on it, CPU tensors of at most one
    element aside: host scalars, as Python numbers are (the learning-rate
    schedule's), and empty placeholders (``checkpoint``'s dummy input)."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.dot_bytes = 0.0
        self.touched_bytes = 0.0
        self.kernel_calls: Dict[str, int] = {}
        #: the device types of every operation's tensors, each with the
        #: first operation seen on it
        self.devices: Dict[str, str] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._before: Dict[str, Dict[str, int]] = {}
        self._after: Dict[str, Dict[str, int]] = {}

    # -- the kernels' reports and the collectives ---------------------------
    def _note(self, name: str, flops: float, nbytes: float) -> None:
        self.dot_flops += flops
        self.dot_bytes += nbytes
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1

    def __enter__(self):
        self._before = collective_counts()
        WORK_SINKS.append(self._note)
        return super().__enter__()

    def __exit__(self, *exc):
        WORK_SINKS.remove(self._note)
        self._after = collective_counts()
        return super().__exit__(*exc)

    def collectives(self) -> Dict[str, Dict[str, float]]:
        """{kind: {"calls", "bytes"}} over the count, the port's kinds."""
        out = {}
        for kind, c in self._after.items():
            b = self._before.get(kind, {"calls": 0, "bytes": 0})
            if c["calls"] > b["calls"]:
                out[kind] = {k: c[k] - b[k] for k in ("calls", "bytes")}
        return out

    def stats(self) -> OpStats:
        nbytes: Dict[str, float] = {}
        calls: Dict[str, float] = {}
        for kind, c in self.collectives().items():
            name, factor = _KINDS[kind]
            nbytes[name] = nbytes.get(name, 0.0) + factor * c["bytes"]
            calls[name] = calls.get(name, 0.0) + c["calls"]
        return OpStats(self.dot_flops, self.dot_bytes, nbytes, calls,
                       self.touched_bytes)

    # -- every operation ----------------------------------------------------
    def _freed(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        ins = list(_tensors(list(args) + list(kwargs.values())))
        for t in ins + outs:
            if t.numel() > 1 or t.device.type != "cpu":
                self.devices.setdefault(t.device.type, str(func))
        if func in _DOTS:
            i = _DOTS[func]
            lhs, rhs = args[i], args[i + 1]
            self.dot_flops += 2.0 * outs[0].numel() * lhs.shape[-1]
            self.dot_bytes += sum(t.numel() * t.element_size()
                                  for t in (lhs, rhs, outs[0]))
        if not func.is_view:
            self.touched_bytes += sum(t.numel() * t.element_size()
                                      for t in ins + outs)
            fresh = [r.alias_info is None for r in func._schema.returns]
            if len(fresh) == 1:  # one result, or one list of them
                fresh *= len(outs)
            for t, new in zip(outs, fresh):
                if new:
                    self._allocated(t)
        return out

    def _allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self.live_bytes += st.nbytes()
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._freed, key)
