"""Port of ``repro/sparse/multifrontal.py``: the ``pipelined`` backend and
the device sweeps.

Ported functions: ``_scatter_entries`` (:128), ``_assemble_bucket`` (:284),
``_route_contributions`` (:348), ``_factor_pipelined`` (:390),
``_bucket_indices`` (:616), ``_build_device_sweeps`` (:631),
``_device_sweep_passes`` (:673), ``_solve_device`` (:695),
``multifrontal_cholesky`` (:190, ``backend="pipelined"`` only) and
``multifrontal_solve`` (:714, ``mode="device"`` only). The ``numpy``,
``pallas`` and ``batched`` backends and the ``seq``/``level`` sweeps are not
ported yet.

* Factorization: the host scatters A's entries into a fresh padded f32
  workspace stack per (level, bucket) and uploads it; the extend-add of the
  children's Schur blocks (:func:`repro_torch.kernels.ops.extend_add_batch`,
  reading the children's factored stacks in place) and the batched partial
  Cholesky (:func:`repro_torch.kernels.ops.frontal_factor_batch_ws`) are
  queued on the current CUDA stream, so the host assembles level *k+1* while
  the card factors level *k*. The factored stacks stay on the device; the one
  host↔device sync is the drain at the end. ``stats`` records
  ``t_factor_assemble`` / ``t_factor_dispatch`` / ``t_factor_sync`` and
  ``overlap_efficiency``.
* Solve: per level-bucket, L11 and L21 are views of the factored stacks and
  the sweep is one gather → batched substitution kernel → scatter step on a
  device-resident (n + 1, K) f32 block whose row ``n`` is the trash row
  every pad index points at. Factors and sweeps run in f32; pair with
  :func:`repro_torch.sparse.refine.refine_solve_device` for fp64 residuals.

The reference padded each extend-add's contribution count to a power of two
to bound jit shapes; eager torch needs no such padding.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..kernels import ops
from .csr import CSRMatrix
from .schedule import FrontPlan, LevelSchedule, build_schedule
from .symbolic import SymbolicFactor, supernodes, symbolic_cholesky

__all__ = ["MultifrontalFactor", "multifrontal_cholesky", "multifrontal_solve"]


@dataclasses.dataclass
class _Front:
    cols: Tuple[int, int]    # [c0, c1) pivot columns
    rows: np.ndarray         # global row indices of the front (sorted; first npiv are pivots)
    L11: np.ndarray          # (npiv, npiv) lower-triangular
    L21: np.ndarray          # (m - npiv, npiv)


@dataclasses.dataclass
class MultifrontalFactor:
    """A pipelined factorization: the factored (B, M, M) f32 workspace stack
    of every (level, bucket) stays on ``device`` (``device_stacks``).
    :attr:`fronts` copies per-front L11/L21 to the host on first use; the
    device sweeps never need it."""

    n: int
    sym: SymbolicFactor
    stats: dict
    schedule: LevelSchedule
    device: torch.device
    device_stacks: Dict[Tuple[int, int], torch.Tensor]
    _fronts: Optional[List[_Front]] = dataclasses.field(
        default=None, repr=False, compare=False)
    _dev_sweeps: Optional["_DeviceSweeps"] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def fronts(self) -> List[_Front]:
        """Per-front (L11, L21) on the host, in supernode order."""
        if self._fronts is None:
            fronts: List[Optional[_Front]] = [None] * self.schedule.nsup
            for (li, bj), W in self.device_stacks.items():
                bucket = self.schedule.buckets[li][bj]
                Wf = W.cpu().numpy()
                P = bucket.P
                for bi, k in enumerate(bucket.members):
                    fp = self.schedule.fronts[k]
                    L11 = np.tril(Wf[bi, : fp.npiv, : fp.npiv])
                    L21 = Wf[bi, P : P + fp.nrest, : fp.npiv]
                    fronts[k] = _Front((fp.c0, fp.c1), fp.rows, L11, L21)
            self._fronts = fronts  # type: ignore[assignment]
        return self._fronts  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Host-side assembly
# ---------------------------------------------------------------------------

def _scatter_entries(F: np.ndarray, a: CSRMatrix, fp: FrontPlan,
                     shift: int = 0) -> None:
    """Scatter A[rows, c0:c1] (lower triangle, via symmetry of the CSR rows)
    into the front workspace in one vectorized pass: global row indices map
    to local positions by ``np.searchsorted`` over the sorted front rows.
    ``shift`` displaces non-pivot rows by the pivot-padding width (the
    batched workspace layout); 0 means the dense unpadded front."""
    indptr, indices, data = a.indptr, a.indices, a.data
    c0, c1 = fp.c0, fp.c1
    start, end = int(indptr[c0]), int(indptr[c1])
    cols = indices[start:end]
    vals = data[start:end]
    colid = np.repeat(np.arange(c0, c1), np.diff(indptr[c0 : c1 + 1]))
    sel = cols >= colid            # keep the lower triangle (row ≥ col)
    loc = np.searchsorted(fp.rows, cols[sel])
    if shift:
        loc = np.where(loc >= fp.npiv, loc + shift, loc)
    F[loc, colid[sel] - c0] = vals[sel]


def _assemble_bucket(a: CSRMatrix, schedule: LevelSchedule, bucket,
                     out: Optional[np.ndarray] = None) -> np.ndarray:
    """Host side of one bucket's assembly: a padded f32 workspace stack
    (``out`` when given, which must be zeroed) with identity pivot-pad
    columns and A's entries scattered in. Pivot padding columns are
    decoupled identity columns; update-row padding is zero rows — both
    factor trivially and contribute nothing to L or the Schur
    complements."""
    B, P, M = len(bucket.members), bucket.P, bucket.M
    W = np.zeros((B, M, M), dtype=np.float32) if out is None else out
    for bi, k in enumerate(bucket.members):
        fp = schedule.fronts[k]
        shift = P - fp.npiv
        if shift:
            pad = np.arange(fp.npiv, P)
            W[bi, pad, pad] = 1.0
        _scatter_entries(W[bi], a, fp, shift)
    return W


def _overlap_timings(t_assemble: float, t_dispatch: float,
                     t_sync: float) -> dict:
    """Solve-stage timing record: ``overlap_efficiency`` is the host-busy
    fraction of the overlappable time, assembly seconds over assembly +
    device-blocked seconds."""
    denom = t_assemble + t_sync
    return dict(t_factor_assemble=t_assemble, t_factor_dispatch=t_dispatch,
                t_factor_sync=t_sync,
                overlap_efficiency=(t_assemble / denom) if denom > 0 else 1.0)


def _route_contributions(schedule: LevelSchedule) -> dict:
    """Precompute the device extend-add routing from the schedule alone.

    Returns ``{(dst_level, dst_bucket): {(src_level, src_bucket):
    [(src_slot, dst_slot, rowmap), ...]}}`` where ``rowmap`` maps the
    source bucket's (padded) update rows to local positions in the padded
    destination workspace (−1 = inactive pad row). Grouping by source
    bucket makes every group one kernel launch.
    """
    loc = {}
    for li in range(schedule.nlevels):
        for bj, bucket in enumerate(schedule.buckets[li]):
            for bi, k in enumerate(bucket.members):
                loc[k] = (li, bj, bi)
    routes: dict = {}
    for fp in schedule.fronts:
        if fp.parent < 0 or fp.nrest == 0:
            continue
        sli, sbj, sbi = loc[fp.k]
        dli, dbj, dbi = loc[fp.parent]
        pfp = schedule.fronts[fp.parent]
        urows = fp.rows[fp.npiv :]
        idx = np.searchsorted(pfp.rows, urows)
        if idx.size and (idx[-1] >= pfp.rows.size
                         or not np.array_equal(pfp.rows[idx], urows)):
            raise RuntimeError(
                "assembly-tree containment violated (supernode "
                f"{fp.k}: update rows not a subset of front rows)")
        shift = schedule.buckets[dli][dbj].P - pfp.npiv
        if shift:
            idx = np.where(idx >= pfp.npiv, idx + shift, idx)
        rowmap = np.full(schedule.buckets[sli][sbj].R, -1, dtype=np.int32)
        rowmap[: fp.nrest] = idx
        (routes.setdefault((dli, dbj), {})
               .setdefault((sli, sbj), []).append((sbi, dbi, rowmap)))
    return routes


# ---------------------------------------------------------------------------
# Numeric phase
# ---------------------------------------------------------------------------

def multifrontal_cholesky(
    a: CSRMatrix,
    sym: Optional[SymbolicFactor] = None,
    relax: int = 8,
    backend: str = "pipelined",
    pad: str = "pow2",
    bs: Optional[int] = None,
    device=None,
) -> MultifrontalFactor:
    """Numeric supernodal factorization of an SPD CSR matrix on ``device``
    (``None`` → CUDA, raising when there is none; ``"cpu"`` runs the plain
    versions of the kernels). ``stats`` adds ``t_factor_schedule``, the host
    time of supernodes, level schedule and extend-add routing, to the
    reference's keys. Fronts are factored in f32; pair with
    :mod:`repro_torch.sparse.refine` for fp64-level residuals. ``pad`` is
    the bucket pad policy of the level schedule (``"pow2"`` / ``"mult8"``)
    and ``bs`` the panel-width cap of the factor kernel (None → 32)."""
    if backend != "pipelined":
        raise ValueError(f"backend {backend!r} is not ported; the port has "
                         f"backend='pipelined'")
    if a.data is None:
        raise ValueError("numeric factorization needs values")
    dev = resolve_device(device)
    if sym is None:
        sym = symbolic_cholesky(a)
    t0 = time.perf_counter()
    snode_ptr, snode_of = supernodes(sym, relax=relax)
    schedule = build_schedule(sym, snode_ptr, snode_of, pad=pad)
    routes = _route_contributions(schedule)
    t_schedule = time.perf_counter() - t0
    timings, stacks = _factor_pipelined(a, schedule, routes, bs=bs,
                                        device=dev)
    stats = dict(schedule.stats())  # nsup, nlevels, widths, occupancy, flops
    stats.update(n=a.n, t_factor_schedule=t_schedule,
                 peak_front=max((fp.m for fp in schedule.fronts), default=0),
                 nnz_L=sym.nnz_L, fill=sym.fill, sym_flops=sym.flops,
                 backend=backend, dtype="float32", bs=bs, **timings)
    return MultifrontalFactor(a.n, sym, stats, schedule, dev, stacks)


def _factor_pipelined(a: CSRMatrix, schedule: LevelSchedule, routes: dict,
                      bs: Optional[int], device: torch.device
                      ) -> Tuple[dict, Dict[Tuple[int, int], torch.Tensor]]:
    """Pipelined device-resident factorization.

    ``routes`` is :func:`_route_contributions` of the schedule. The host's
    only numeric work is scattering A's entries into fresh
    bucket workspaces, assembled in pinned memory and copied asynchronously.
    The extend-add and the partial factorization are queued on the current
    stream and return at once, so the host assembles the next bucket while
    the card factors this one. Each factored stack stays on the device until
    the end (its members' parents read their Schur blocks from it); the one
    blocking sync is the drain at the end.
    """
    pc = time.perf_counter
    cuda = device.type == "cuda"
    dev: Dict[Tuple[int, int], torch.Tensor] = {}
    t_asm = t_disp = 0.0
    for li in range(schedule.nlevels):
        for bj, bucket in enumerate(schedule.buckets[li]):
            t0 = pc()
            shape = (len(bucket.members), bucket.M, bucket.M)
            host = torch.zeros(shape, dtype=torch.float32, pin_memory=cuda)
            _assemble_bucket(a, schedule, bucket, out=host.numpy())
            t_asm += pc() - t0
            t0 = pc()
            w = host.to(device, non_blocking=True) if cuda else host
            for (sli, sbj), contribs in sorted(
                    routes.get((li, bj), {}).items()):
                contribs.sort(key=lambda c: c[1])  # ascending dst slots
                src = np.array([c[0] for c in contribs], dtype=np.int32)
                dst = np.array([c[1] for c in contribs], dtype=np.int32)
                rows = np.stack([c[2] for c in contribs])
                ops.extend_add_batch(w, dev[(sli, sbj)], dst, rows, src=src,
                                     off=schedule.buckets[sli][sbj].P)
            dev[(li, bj)] = ops.frontal_factor_batch_ws(w, bucket.P, bs=bs)
            t_disp += pc() - t0
    # drain: the only host↔device sync — by now the host has assembled and
    # dispatched every level, so this wait is whatever device work is left
    t0 = pc()
    if cuda:
        torch.cuda.synchronize(device)
    t_sync = pc() - t0
    return _overlap_timings(t_asm, t_disp, t_sync), dev


# ---------------------------------------------------------------------------
# Device-resident triangular sweeps
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _DeviceSweepGroup:
    """One level-bucket's factors as device tensors. L11 and L21 are views
    of the factored workspace stack (the substitution kernel reads only the
    lower triangle of L11). Index pads point at the trash row ``n``: the
    identity pad rows of L11 and the zero pad rows/cols of L21 keep whatever
    the trash row holds out of every real entry."""

    L11: torch.Tensor          # (B, P, P) view, unit-diagonal padded
    L21: torch.Tensor          # (B, R, P) view
    piv: torch.Tensor          # (B, P) int64, pads -> n
    rest: torch.Tensor         # (B, R) int64, pads -> n


@dataclasses.dataclass
class _DeviceSweeps:
    levels: List[List[_DeviceSweepGroup]]


def _bucket_indices(sched: LevelSchedule, bucket, n: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(B, P) pivot and (B, R) update-row index stacks for one bucket,
    pads pointed at the trash row ``n``."""
    B, P, R = len(bucket.members), bucket.P, bucket.R
    piv = np.full((B, P), n, dtype=np.int64)
    rest = np.full((B, R), n, dtype=np.int64)
    for bi, k in enumerate(bucket.members):
        fp = sched.fronts[k]
        piv[bi, : fp.npiv] = np.arange(fp.c0, fp.c1, dtype=np.int64)
        rest[bi, : fp.nrest] = fp.rows[fp.npiv :]
    return piv, rest


def _build_device_sweeps(f: MultifrontalFactor) -> _DeviceSweeps:
    """Slice each level-bucket's L11/L21 out of the factored device stacks
    and upload its index stacks (once per factor)."""
    sched = f.schedule
    levels: List[List[_DeviceSweepGroup]] = []
    for li in range(sched.nlevels):
        groups: List[_DeviceSweepGroup] = []
        for bj, bucket in enumerate(sched.buckets[li]):
            W = f.device_stacks[(li, bj)]
            P = bucket.P
            piv, rest = _bucket_indices(sched, bucket, f.n)
            groups.append(_DeviceSweepGroup(
                W[:, :P, :P], W[:, P:, :P], to_device(piv, f.device),
                to_device(rest, f.device)))
        levels.append(groups)
    return _DeviceSweeps(levels)


def _device_sweep_passes(f: MultifrontalFactor, x: torch.Tensor, *,
                         sweep_bs: Optional[int] = None,
                         rt: Optional[int] = None) -> torch.Tensor:
    """Forward + backward substitution in place on a device-resident
    (n + 1, K) f32 block. One queued gather → kernel → scatter step per
    level-bucket; no host sync — callers decide when to read the result."""
    if f._dev_sweeps is None:
        f._dev_sweeps = _build_device_sweeps(f)
    sw = f._dev_sweeps
    for groups in sw.levels:
        for g in groups:
            ops.sweep_forward(x, g.L11, g.L21, g.piv, g.rest, bs=sweep_bs,
                              rt=rt)
    for groups in reversed(sw.levels):
        for g in groups:
            ops.sweep_backward(x, g.L11, g.L21, g.piv, g.rest, bs=sweep_bs,
                               rt=rt)
    return x


def _solve_device(f: MultifrontalFactor, b2: np.ndarray, *,
                  sweep_bs: Optional[int] = None,
                  rt: Optional[int] = None) -> np.ndarray:
    """Device-resident sweeps for an (n, k) RHS block: upload once, one
    queued step per level-bucket, one sync to fetch the solution."""
    n, k = b2.shape
    x = torch.zeros((n + 1, k), dtype=torch.float32, device=f.device)
    x[:n] = to_device(np.asarray(b2, dtype=np.float32), f.device)
    x = _device_sweep_passes(f, x, sweep_bs=sweep_bs, rt=rt)
    return x[:n].cpu().numpy().astype(np.float64)


def multifrontal_solve(f: MultifrontalFactor, b: np.ndarray,
                       mode: str = "device", *,
                       sweep_bs: Optional[int] = None,
                       rt: Optional[int] = None) -> np.ndarray:
    """Solve A x = b with the supernodal factor through the device sweeps
    (f32; pair with refinement for fp64 residuals). ``b`` may be ``(n,)`` or
    ``(n, k)``; the result has its shape, in fp64. ``sweep_bs``/``rt`` are
    the sweep knobs (tri-solve panel cap and RHS tile width)."""
    if mode != "device":
        raise ValueError(f"sweep mode {mode!r} is not ported; the port has "
                         f"mode='device'")
    b = np.asarray(b)
    single = b.ndim == 1
    x = _solve_device(f, b[:, None] if single else b, sweep_bs=sweep_bs,
                      rt=rt)
    return x[:, 0] if single else x
