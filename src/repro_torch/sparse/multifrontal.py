"""Port of ``repro/sparse/multifrontal.py``: the supernodal multifrontal
Cholesky with its four backends and its four sweep modes.

Ported functions: ``_scatter_entries`` (:128), ``_extend_add`` (:148),
``_partial_factor_numpy`` (:166), ``_partial_factor_pallas`` (:180),
``multifrontal_cholesky`` (:190), ``_factor_sequential`` (:246),
``_assemble_bucket`` (:284), ``_factor_batched`` (:303),
``_route_contributions`` (:348), ``_factor_pipelined`` (:390), the host
sweeps ``_build_sweeps``, ``_solve_level`` and ``_solve_sequential``
(:496-592), the device sweeps ``_bucket_indices``, ``_build_device_sweeps``,
``_device_sweep_passes`` and ``_solve_device`` (:616-708),
``multifrontal_solve`` (:714), ``factor_and_solve_timed`` (:750) and the
request-context deadline check ``_check_deadline`` (:80).

Backends (``backend=``):

* ``numpy``: host BLAS, one front at a time, in ``dtype`` (fp64 by
  default); the labeling campaign times it.
* ``pallas``: one front at a time through
  :func:`repro_torch.kernels.ops.frontal_factor`, whose three tile kernels
  (``chol_tile``, ``tri_inv_tile``, ``matmul_nt``) run on ``device``. As in
  the reference, each front goes up to the device and its factor comes back
  to the host (one round trip per front), and extend-add runs on the host.
* ``batched``: per (level, bucket) one ``frontal_factor_batch_ws`` call on a
  padded stack; extend-add on the host, one round trip per bucket.
* ``pipelined`` (the default here; the reference's default is ``numpy``):
  the host scatters A's entries into pinned workspace stacks per (level,
  bucket) and uploads them; the extend-add of the children's Schur blocks
  (one ``extend_add_routed`` launch per fed bucket, reading the children's
  factored stacks in place, its routing built by :func:`_device_routing`
  and uploaded once) and the batched partial Cholesky are queued on the
  current CUDA stream, so the host assembles level *k+1* while the card
  factors level *k*. The factored stacks stay on the device; the one sync
  is the drain at the end.

The device backends factor in f32. ``stats`` adds ``t_factor_schedule``
(supernodes, level schedule and, for ``pipelined``, the extend-add routing)
to the reference's keys; the device backends record ``t_factor_assemble``
(host), ``t_factor_dispatch`` (uploads and kernel launches) and
``t_factor_sync`` (waiting for the device: the blocking round trips of
``pallas`` and ``batched``, the final drain of ``pipelined``).

Sweeps (``multifrontal_solve(mode=)``): ``seq`` per front with scipy and
``level`` per level-bucket with numpy, both fp64 on the host; ``device``
per level-bucket as one gather → batched substitution kernel → scatter step
on a device-resident (n + 1, K) f32 block whose row ``n`` is the trash row
every pad index points at. After ``pipelined`` the device sweeps read L11
and L21 straight out of the factored stacks; after any other backend the
host fronts are stacked and uploaded once. ``device`` is the default
here, as ``pipelined`` is the factor's; ``auto`` is ``level``. Pair the
f32 paths with :mod:`repro_torch.sparse.refine` for fp64 residuals.

``multifrontal_cholesky(ctx=...)`` takes a
:class:`~repro_torch.core.reqctx.RequestContext`, as the reference's does:
it checks the deadline at the start of the factorization, before each level
of ``batched``, before each level ``pipelined`` dispatches, and before and
after ``pipelined``'s drain (the port drains in one sync where the
reference fetched level by level), and raises
:class:`~repro_torch.core.reqctx.DeadlineExceeded` once it has passed.

The reference padded each extend-add's contribution count to a power of two
to bound jit shapes; eager torch needs no such padding.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.linalg as sla
import torch

from ..device import resolve_device, to_device
from ..kernels import ops
from ..kernels.frontal_cholesky import (ExtendAddRouting,
                                        extend_add_routing_arrays)
from .csr import CSRMatrix
from .schedule import FrontPlan, LevelSchedule, build_schedule
from .symbolic import SymbolicFactor, supernodes, symbolic_cholesky

__all__ = ["MultifrontalFactor", "multifrontal_cholesky", "multifrontal_solve",
           "factor_and_solve_timed", "BACKENDS", "DEVICE_BACKENDS",
           "SWEEP_MODES"]

BACKENDS = ("numpy", "pallas", "batched", "pipelined")
#: backends that factor fronts in f32 on the device
DEVICE_BACKENDS = ("pallas", "batched", "pipelined")
SWEEP_MODES = ("auto", "seq", "level", "device")


@dataclasses.dataclass
class _Front:
    cols: Tuple[int, int]    # [c0, c1) pivot columns
    rows: np.ndarray         # global row indices of the front (sorted; first npiv are pivots)
    L11: np.ndarray          # (npiv, npiv) lower-triangular
    L21: np.ndarray          # (m - npiv, npiv)


@dataclasses.dataclass
class MultifrontalFactor:
    """A supernodal factorization. The ``numpy``, ``pallas`` and ``batched``
    backends leave per-front L11/L21 on the host (``fronts``); the
    ``pipelined`` one leaves the factored (B, M, M) f32 workspace stack of
    every (level, bucket) on ``device`` (``device_stacks``), and
    :attr:`fronts` copies per-front L11/L21 from them to the host on first
    use (the device sweeps never need it). ``device`` is where device work
    runs: None after a ``numpy`` factorization that was given none, until a
    device sweep resolves it."""

    n: int
    sym: SymbolicFactor
    stats: dict
    schedule: LevelSchedule
    device: Optional[torch.device]
    dtype: np.dtype
    device_stacks: Optional[Dict[Tuple[int, int], torch.Tensor]] = None
    _fronts: Optional[List[_Front]] = dataclasses.field(
        default=None, repr=False, compare=False)
    _sweeps: Optional["_LevelSweeps"] = dataclasses.field(
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

def _check_deadline(ctx, stage: str) -> None:
    """Deadline checkpoint at a level boundary of the numeric phase: a
    request whose context's deadline has passed raises
    :class:`~repro_torch.core.reqctx.DeadlineExceeded` mid-factorization
    instead of spending the remaining levels on an answer nobody waits for.
    ``ctx`` is duck-typed (``expired()`` / ``remaining()``); the import is
    lazy, as ``repro_torch.core`` imports this module."""
    if ctx is None or not ctx.expired():
        return
    from ..core.reqctx import DeadlineExceeded

    late_ms = -(ctx.remaining() or 0.0) * 1e3
    raise DeadlineExceeded(
        f"deadline exceeded {late_ms:.1f} ms ago at {stage} — "
        f"factorization abandoned")


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


def _extend_add(F: np.ndarray, fp: FrontPlan, urows: np.ndarray,
                U: np.ndarray, shift: int = 0) -> None:
    """Add a child's Schur update (rows ``urows``) into the front workspace
    on the host; ``shift`` as in :func:`_scatter_entries`."""
    idx = np.searchsorted(fp.rows, urows)
    if idx.size and (idx[-1] >= fp.rows.size
                     or not np.array_equal(fp.rows[idx], urows)):
        raise RuntimeError(
            "assembly-tree containment violated (supernode "
            f"{fp.k}: update rows not a subset of front rows)")
    if shift:
        idx = np.where(idx >= fp.npiv, idx + shift, idx)
    F[np.ix_(idx, idx)] += U


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


def _device_routing(schedule: LevelSchedule
                    ) -> Tuple[ExtendAddRouting, dict]:
    """The extend-add routing of every fed bucket, built from the schedule
    alone with vectorised NumPy, for one upload per factorization. It holds
    the contributions of :func:`_route_contributions` (which stays as it
    is) in the order the per-group launches ran them: per fed bucket, its
    source buckets in key order, each one's contributions by ascending
    destination slot, then by front. Returns the routing and
    ``{(level, bucket): (destination index, source bucket keys)}``."""
    keys = [(li, bj) for li in range(schedule.nlevels)
            for bj in range(len(schedule.buckets[li]))]
    bks = [schedule.buckets[li][bj] for li, bj in keys]
    fronts = schedule.fronts
    bid = np.empty(schedule.nsup, np.int64)     # bucket of each front
    slot = np.empty(schedule.nsup, np.int64)    # its slot there
    for b, bk in enumerate(bks):
        bid[bk.members] = b
        slot[bk.members] = np.arange(len(bk.members))
    P = np.array([bk.P for bk in bks], np.int64)
    npiv = np.array([fp.c1 - fp.c0 for fp in fronts], np.int64)
    parent = np.array([fp.parent for fp in fronts], np.int64)
    m = np.array([fp.rows.size for fp in fronts], np.int64)
    rows = np.concatenate([fp.rows for fp in fronts]).astype(np.int64)
    start = np.r_[0, np.cumsum(m)]
    kids = np.flatnonzero((parent >= 0) & (m > npiv))
    par = parent[kids]
    kids = kids[np.lexsort((kids, slot[par], bid[kids], bid[par]))]
    par, nrest = parent[kids], m[kids] - npiv[kids]
    fed_b, c_dest = np.unique(bid[par], return_inverse=True)
    new_group = np.ones(kids.size, bool)
    new_group[1:] = ((bid[par][1:] != bid[par][:-1])
                     | (bid[kids][1:] != bid[kids][:-1]))
    gid = np.cumsum(new_group) - 1
    c_group = gid - gid[np.searchsorted(c_dest, c_dest)]
    # each update row's position in the parent front (searchsorted over the
    # parents' sorted rows, keyed by front), shifted past the pivot padding
    e_c = np.repeat(np.arange(kids.size), nrest)
    e_i = np.arange(e_c.size) - np.repeat(np.cumsum(nrest) - nrest, nrest)
    urow = rows[start[kids][e_c] + npiv[kids][e_c] + e_i]
    width = int(rows.max(initial=0)) + 1
    front_keys = np.repeat(np.arange(schedule.nsup), m) * width + rows
    want = par[e_c] * width + urow
    pos = np.minimum(np.searchsorted(front_keys, want),
                     max(front_keys.size - 1, 0))
    bad = front_keys[pos] != want if want.size else np.zeros(0, bool)
    if np.any(bad):
        raise RuntimeError(
            "assembly-tree containment violated (supernode "
            f"{kids[e_c[np.argmax(bad)]]}: update rows not a subset of front "
            "rows)")
    loc = pos - start[par[e_c]]
    pe = par[e_c]
    loc = np.where(loc >= npiv[pe], loc + P[bid[pe]] - npiv[pe], loc)
    first = np.flatnonzero(new_group)        # each group's first contribution
    routing = extend_add_routing_arrays(
        [bks[b].M for b in fed_b], np.bincount(c_dest[first],
                                               minlength=fed_b.size),
        c_dest, c_group, slot[kids], slot[par],
        np.array([bk.R for bk in bks], np.int64)[bid[kids]], e_c, e_i, loc)
    fed = {keys[b]: (d, []) for d, b in enumerate(fed_b)}
    for c in first:
        fed[keys[bid[par[c]]]][1].append(keys[bid[kids[c]]])
    return routing, fed


# ---------------------------------------------------------------------------
# Dense partial factorization of one front (numpy / pallas backends)
# ---------------------------------------------------------------------------

def _partial_factor_numpy(F: np.ndarray, npiv: int):
    """Dense partial Cholesky on the host: factor the pivot block, solve
    the panel, form the Schur complement."""
    F11 = F[:npiv, :npiv]
    L11 = np.linalg.cholesky(F11)
    if F.shape[0] > npiv:
        L21 = sla.solve_triangular(L11, F[npiv:, :npiv].T, lower=True,
                                   trans="N").T
        S = F[npiv:, npiv:] - L21 @ L21.T
    else:
        L21 = np.empty((0, npiv), dtype=F.dtype)
        S = np.empty((0, 0), dtype=F.dtype)
    return L11, L21, S


def _partial_factor_pallas(F: np.ndarray, npiv: int, device: torch.device):
    """Upload one front and queue its factorization by
    :func:`ops.frontal_factor` (the three tile kernels): returns (L11, L21,
    S) on ``device``; the caller copies them back (the reference's
    per-front round trip)."""
    return ops.frontal_factor(to_device(F, device), npiv)


# ---------------------------------------------------------------------------
# Numeric phase
# ---------------------------------------------------------------------------

def multifrontal_cholesky(
    a: CSRMatrix,
    sym: Optional[SymbolicFactor] = None,
    relax: int = 8,
    backend: str = "pipelined",
    dtype=np.float64,
    pad: str = "pow2",
    bs: Optional[int] = None,
    device=None,
    ctx=None,
) -> MultifrontalFactor:
    """Numeric supernodal factorization of an SPD CSR matrix.

    The device backends (``pallas``, ``batched``, ``pipelined``) run on
    ``device`` (``None`` → CUDA, raising when there is none; ``"cpu"`` runs
    the plain versions of the kernels) and factor in f32; pair them with
    :mod:`repro_torch.sparse.refine` for fp64-level residuals. ``numpy``
    runs on the host in ``dtype`` and resolves ``device`` only when one is
    given. ``pad`` is the bucket pad policy of the level schedule
    (``"pow2"`` / ``"mult8"``) and ``bs`` the panel-width cap of the batched
    factor kernel (None → 32). ``ctx`` is an optional request context whose
    deadline is checked at level boundaries (see the module docstring)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if a.data is None:
        raise ValueError("numeric factorization needs values")
    dev = (resolve_device(device)
           if backend in DEVICE_BACKENDS or device is not None else None)
    if sym is None:
        sym = symbolic_cholesky(a)
    eff_dtype = np.dtype(np.float32 if backend in DEVICE_BACKENDS else dtype)
    _check_deadline(ctx, "factorization start")
    t0 = time.perf_counter()
    snode_ptr, snode_of = supernodes(sym, relax=relax)
    schedule = build_schedule(sym, snode_ptr, snode_of, pad=pad)
    routing = _device_routing(schedule) if backend == "pipelined" else None
    t_schedule = time.perf_counter() - t0
    fronts, stacks = None, None
    if backend == "pipelined":
        timings, stacks = _factor_pipelined(a, schedule, routing, bs=bs,
                                            device=dev, ctx=ctx)
    elif backend == "batched":
        fronts, timings = _factor_batched(a, schedule, bs=bs, device=dev,
                                          ctx=ctx)
    else:
        fronts, timings = _factor_sequential(a, schedule, backend, eff_dtype,
                                             dev)
    stats = dict(schedule.stats())  # nsup, nlevels, widths, occupancy, flops
    stats.update(n=a.n, t_factor_schedule=t_schedule,
                 peak_front=max((fp.m for fp in schedule.fronts), default=0),
                 nnz_L=sym.nnz_L, fill=sym.fill, sym_flops=sym.flops,
                 backend=backend, dtype=str(eff_dtype), bs=bs, **timings)
    return MultifrontalFactor(a.n, sym, stats, schedule, dev, eff_dtype,
                              device_stacks=stacks, _fronts=fronts)


def _factor_sequential(a: CSRMatrix, schedule: LevelSchedule, backend: str,
                       dtype: np.dtype, device: Optional[torch.device]
                       ) -> Tuple[List[_Front], dict]:
    """Front-at-a-time postorder traversal (numpy / per-front pallas).
    ``pallas`` also returns the host assembly time, the time to upload each
    front and queue its kernels (``t_factor_dispatch``) and the time of the
    blocking copies back (``t_factor_sync``)."""
    pc = time.perf_counter
    pending: List[List[Tuple[np.ndarray, np.ndarray]]] = [
        [] for _ in range(schedule.nsup)]
    fronts: List[_Front] = []
    t_asm = t_disp = t_sync = 0.0
    for fp in schedule.fronts:
        t0 = pc()
        F = np.zeros((fp.m, fp.m), dtype=dtype)
        _scatter_entries(F, a, fp)
        for (urows, U) in pending[fp.k]:
            _extend_add(F, fp, urows, U)
        pending[fp.k] = []
        t1 = pc()
        t_asm += t1 - t0
        if backend == "numpy":
            L11, L21, S = _partial_factor_numpy(F, fp.npiv)
        else:
            out = _partial_factor_pallas(F, fp.npiv, device)
            t2 = pc()
            L11, L21, S = (t.cpu().numpy() for t in out)
            t_disp += t2 - t1
            t_sync += pc() - t2
        fronts.append(_Front((fp.c0, fp.c1), fp.rows, L11, L21))
        if fp.nrest:
            pending[fp.parent].append((fp.rows[fp.npiv :], S))
    if backend == "numpy":
        return fronts, {}
    return fronts, _overlap_timings(t_asm, t_disp, t_sync)


def _factor_batched(a: CSRMatrix, schedule: LevelSchedule,
                    bs: Optional[int], device: torch.device, ctx=None
                    ) -> Tuple[List[_Front], dict]:
    """Level-scheduled factorization: per (level, bucket), assemble every
    member front into one padded f32 workspace stack on the host (A's
    entries and the children's Schur blocks), factor the stack with one
    ``frontal_factor_batch_ws`` call and bring it back (a blocking round
    trip per bucket). The ``pipelined`` backend removes both host steps."""
    pc = time.perf_counter
    fronts: List[Optional[_Front]] = [None] * schedule.nsup
    pending: List[List[Tuple[np.ndarray, np.ndarray]]] = [
        [] for _ in range(schedule.nsup)]
    t_asm = t_sync = 0.0
    for li in range(schedule.nlevels):
        _check_deadline(ctx, f"batched level {li}/{schedule.nlevels}")
        for bucket in schedule.buckets[li]:
            t0 = pc()
            P = bucket.P
            W = _assemble_bucket(a, schedule, bucket)
            for bi, k in enumerate(bucket.members):
                fp = schedule.fronts[k]
                for (urows, U) in pending[k]:
                    _extend_add(W[bi], fp, urows, U, P - fp.npiv)
                pending[k] = []
            t_asm += pc() - t0
            t0 = pc()
            Wf = ops.frontal_factor_batch_ws(to_device(W, device), P,
                                             bs=bs).cpu().numpy()
            t_sync += pc() - t0
            t0 = pc()
            for bi, k in enumerate(bucket.members):
                fp = schedule.fronts[k]
                npiv, nrest = fp.npiv, fp.nrest
                L11 = np.tril(Wf[bi, :npiv, :npiv])
                L21 = Wf[bi, P : P + nrest, :npiv]
                fronts[k] = _Front((fp.c0, fp.c1), fp.rows, L11, L21)
                if nrest:
                    S = Wf[bi, P : P + nrest, P : P + nrest]
                    pending[fp.parent].append((fp.rows[npiv:], S))
            t_asm += pc() - t0
    return fronts, _overlap_timings(t_asm, 0.0, t_sync)  # type: ignore[return-value]


def _factor_pipelined(a: CSRMatrix, schedule: LevelSchedule,
                      routing: Tuple[ExtendAddRouting, dict],
                      bs: Optional[int], device: torch.device, ctx=None
                      ) -> Tuple[dict, Dict[Tuple[int, int], torch.Tensor]]:
    """Pipelined device-resident factorization.

    ``routing`` is :func:`_device_routing` of the schedule; it goes up to
    the device in one copy before the first bucket. The host's only numeric
    work is scattering A's entries into fresh bucket workspaces, assembled
    in pinned memory and copied asynchronously. The extend-add (one launch
    per fed bucket, reading every source stack of it) and the partial
    factorization are queued on the current stream and return at once, so
    the host assembles the next bucket while the card factors this one.
    Each factored stack stays on the device until the end (its members'
    parents read their Schur blocks from it); the one blocking sync is the
    drain at the end.
    """
    pc = time.perf_counter
    cuda = device.type == "cuda"
    dev: Dict[Tuple[int, int], torch.Tensor] = {}
    t0 = pc()
    ea_routing, fed = routing
    ea_routing = ea_routing.to(device)
    t_asm, t_disp = 0.0, pc() - t0
    for li in range(schedule.nlevels):
        _check_deadline(ctx, f"pipelined dispatch level "
                             f"{li}/{schedule.nlevels}")
        for bj, bucket in enumerate(schedule.buckets[li]):
            t0 = pc()
            shape = (len(bucket.members), bucket.M, bucket.M)
            host = torch.zeros(shape, dtype=torch.float32, pin_memory=cuda)
            _assemble_bucket(a, schedule, bucket, out=host.numpy())
            t_asm += pc() - t0
            t0 = pc()
            w = host.to(device, non_blocking=True) if cuda else host
            if (li, bj) in fed:
                d, skeys = fed[(li, bj)]
                ops.extend_add_routed(
                    w, [dev[k] for k in skeys],
                    [schedule.buckets[k[0]][k[1]].P for k in skeys],
                    ea_routing, d)
            dev[(li, bj)] = ops.frontal_factor_batch_ws(w, bucket.P, bs=bs)
            t_disp += pc() - t0
    # drain: the only host↔device sync — by now the host has assembled and
    # dispatched every level, so this wait is whatever device work is left
    _check_deadline(ctx, "pipelined drain")
    t0 = pc()
    if cuda:
        torch.cuda.synchronize(device)
    t_sync = pc() - t0
    _check_deadline(ctx, "pipelined drain end")
    return _overlap_timings(t_asm, t_disp, t_sync), dev


# ---------------------------------------------------------------------------
# Host triangular sweeps (fp64)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _SweepGroup:
    """One level-bucket's factors stacked for batched substitution."""

    L11: np.ndarray        # (B, P, P) unit-diag padded, fp64
    L11T: np.ndarray       # (B, P, P) transposed copy (backward sweep)
    L21: np.ndarray        # (B, R, P)
    piv: np.ndarray        # (B, P) global pivot indices (0 at pads)
    pmask: np.ndarray      # (B, P) bool, True at real pivots
    rest: np.ndarray       # (B, R) global update rows (0 at pads)
    rmask: np.ndarray      # (B, R) bool


@dataclasses.dataclass
class _LevelSweeps:
    levels: List[List[_SweepGroup]]


def _stack_fronts(f: MultifrontalFactor, bucket, dtype
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """One bucket's host fronts stacked in ``dtype``: (B, P, P) L11,
    unit-diagonal padded, and (B, R, P) L21, zero padded."""
    B, P, R = len(bucket.members), bucket.P, bucket.R
    L11 = np.zeros((B, P, P), dtype=dtype)
    diag = np.arange(P)
    L11[:, diag, diag] = 1.0
    L21 = np.zeros((B, R, P), dtype=dtype)
    for bi, k in enumerate(bucket.members):
        fr = f.fronts[k]
        npiv = fr.cols[1] - fr.cols[0]
        L11[bi, :npiv, :npiv] = fr.L11
        L21[bi, : fr.L21.shape[0], :npiv] = fr.L21
    return L11, L21


def _build_sweeps(f: MultifrontalFactor) -> _LevelSweeps:
    """Stack each level-bucket's host fronts, unit-diagonal padded."""
    sched = f.schedule
    levels: List[List[_SweepGroup]] = []
    for li in range(sched.nlevels):
        groups: List[_SweepGroup] = []
        for bucket in sched.buckets[li]:
            B, P, R = len(bucket.members), bucket.P, bucket.R
            L11, L21 = _stack_fronts(f, bucket, np.float64)
            piv = np.zeros((B, P), dtype=np.int64)
            pmask = np.zeros((B, P), dtype=bool)
            rest = np.zeros((B, R), dtype=np.int64)
            rmask = np.zeros((B, R), dtype=bool)
            for bi, k in enumerate(bucket.members):
                fp = sched.fronts[k]
                piv[bi, : fp.npiv] = np.arange(fp.c0, fp.c1)
                pmask[bi, : fp.npiv] = True
                rest[bi, : fp.nrest] = fp.rows[fp.npiv :]
                rmask[bi, : fp.nrest] = True
            groups.append(_SweepGroup(
                L11, np.ascontiguousarray(L11.transpose(0, 2, 1)), L21,
                piv, pmask, rest, rmask))
        levels.append(groups)
    return _LevelSweeps(levels)


def _solve_level(f: MultifrontalFactor, x: np.ndarray) -> None:
    """Level-batched forward/backward sweeps, in place on the (n, k) fp64
    RHS block: one batched ``np.linalg.solve`` on the stacked unit-padded
    factors plus one batched update einsum per level-bucket. Update scatters
    within a level never collide with that level's pivots (parents live on
    higher levels), so each level's cross-front updates are applied in one
    ``np.bincount`` scatter-add."""
    if f._sweeps is None:
        f._sweeps = _build_sweeps(f)
    sw = f._sweeps
    n, k = x.shape
    colk = np.arange(k)
    # forward: L y = b, leaves upward
    for groups in sw.levels:
        acc_idx: List[np.ndarray] = []
        acc_upd: List[np.ndarray] = []
        for g in groups:
            xb = np.where(g.pmask[..., None], x[g.piv], 0.0)
            y = np.linalg.solve(g.L11, xb)
            x[g.piv[g.pmask]] = y[g.pmask]
            if g.rest.shape[1]:
                upd = np.einsum("brp,bpk->brk", g.L21, y)
                acc_idx.append(g.rest[g.rmask])
                acc_upd.append(upd[g.rmask])
        if acc_idx:
            idx = np.concatenate(acc_idx)
            upd = np.concatenate(acc_upd)
            flat = (idx[:, None] * k + colk).ravel()
            x -= np.bincount(flat, weights=upd.ravel(),
                             minlength=n * k).reshape(n, k)
    # backward: Lᵀ x = y, roots downward
    for groups in reversed(sw.levels):
        for g in groups:
            rhs = np.where(g.pmask[..., None], x[g.piv], 0.0)
            if g.rest.shape[1]:
                xr = np.where(g.rmask[..., None], x[g.rest], 0.0)
                rhs = rhs - np.einsum("brp,brk->bpk", g.L21, xr)
            y = np.linalg.solve(g.L11T, rhs)
            x[g.piv[g.pmask]] = y[g.pmask]


def _solve_sequential(f: MultifrontalFactor, x: np.ndarray) -> None:
    """Per-front scipy sweeps, in place on the (n, k) fp64 RHS block."""
    for fr in f.fronts:
        c0, c1 = fr.cols
        piv = slice(c0, c1)
        y = sla.solve_triangular(fr.L11, x[piv], lower=True)
        x[piv] = y
        if fr.L21.shape[0]:
            x[fr.rows[c1 - c0 :]] -= fr.L21 @ y
    for fr in reversed(f.fronts):
        c0, c1 = fr.cols
        piv = slice(c0, c1)
        rhs = x[piv]
        if fr.L21.shape[0]:
            rhs = rhs - fr.L21.T @ x[fr.rows[c1 - c0 :]]
        x[piv] = sla.solve_triangular(fr.L11.T, rhs, lower=False)


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


def sweep_device(f: MultifrontalFactor) -> torch.device:
    """The device of ``f``'s device sweeps: the factorization's, or for a
    ``numpy`` factor given none, CUDA (raising when there is no card)."""
    if f.device is None:
        f.device = resolve_device(None)
    return f.device


def _build_device_sweeps(f: MultifrontalFactor) -> _DeviceSweeps:
    """Each level-bucket's L11/L21 as device tensors, and its index stacks
    (once per factor). After ``pipelined`` they are views of the factored
    device stacks, whose identity pivot pads factored to unit-diagonal rows
    and update-row pads to zero rows: the inert padding the sweeps need.
    After any other backend the host fronts are stacked in f32
    (unit-diagonal padded) and uploaded."""
    sched = f.schedule
    dev = sweep_device(f)
    levels: List[List[_DeviceSweepGroup]] = []
    for li in range(sched.nlevels):
        groups: List[_DeviceSweepGroup] = []
        for bj, bucket in enumerate(sched.buckets[li]):
            P = bucket.P
            if f.device_stacks is not None:
                W = f.device_stacks[(li, bj)]
                L11, L21 = W[:, :P, :P], W[:, P:, :P]
            else:
                L11, L21 = (to_device(t, dev) for t in
                            _stack_fronts(f, bucket, np.float32))
            piv, rest = _bucket_indices(sched, bucket, f.n)
            groups.append(_DeviceSweepGroup(L11, L21, to_device(piv, dev),
                                            to_device(rest, dev)))
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
    dev = sweep_device(f)
    x = torch.zeros((n + 1, k), dtype=torch.float32, device=dev)
    x[:n] = to_device(np.asarray(b2, dtype=np.float32), dev)
    x = _device_sweep_passes(f, x, sweep_bs=sweep_bs, rt=rt)
    return x[:n].cpu().numpy().astype(np.float64)


def multifrontal_solve(f: MultifrontalFactor, b: np.ndarray,
                       mode: str = "device", *,
                       sweep_bs: Optional[int] = None,
                       rt: Optional[int] = None) -> np.ndarray:
    """Solve A x = b with the supernodal factor. ``b`` may be ``(n,)`` or
    ``(n, k)``; the result has its shape, in fp64.

    ``mode="device"`` (the default here, as ``pipelined`` is the factor's;
    the reference's default is ``"auto"``) runs the batched substitution
    kernels on device-resident factor stacks in f32 (pair with refinement
    for fp64 residuals); ``"level"`` (what ``"auto"`` picks: the port's
    factors always carry a schedule) runs the host level-batched sweeps in
    fp64, and ``"seq"`` the per-front loop. ``sweep_bs``/``rt`` are the device sweep's knobs (tri-solve
    panel cap and RHS tile width); the host modes ignore them. Repeated
    solves reuse the stacked sweep tensors cached on the factor."""
    if mode not in SWEEP_MODES:
        raise ValueError(f"unknown sweep mode {mode!r}; expected one of "
                         f"{SWEEP_MODES}")
    if mode == "auto":
        mode = "level"
    b = np.asarray(b)
    single = b.ndim == 1
    if mode == "device":
        x = _solve_device(f, b[:, None] if single else b, sweep_bs=sweep_bs,
                          rt=rt)
        return x[:, 0] if single else x
    x = np.array(b, dtype=np.float64)   # the one owned fp64 copy
    x2 = x[:, None] if single else x    # view: the sweeps work in place
    if mode == "seq":
        _solve_sequential(f, x2)
    else:
        _solve_level(f, x2)
    return x


def factor_and_solve_timed(a: CSRMatrix, b: Optional[np.ndarray] = None,
                           relax: int = 8,
                           sym: Optional[SymbolicFactor] = None,
                           backend: str = "numpy",
                           pad: str = "pow2",
                           bs: Optional[int] = None,
                           sweep: str = "auto",
                           sweep_bs: Optional[int] = None,
                           rt: Optional[int] = None,
                           device=None) -> dict:
    """Measured factor + solve wall time: the per-(matrix, ordering) label
    signal, standing in for the paper's MUMPS timings. The defaults are the
    reference's (host ``numpy`` factor, ``auto`` sweeps, no device).

    A given ``sym`` skips the symbolic stage (``t_symbolic`` is then 0).
    ``b`` defaults to a seeded standard normal vector. Returns ``time``,
    ``t_symbolic``, ``t_factor``, ``t_solve``, ``residual`` and the factor's
    ``stats``."""
    if b is None:
        b = np.random.default_rng(0).standard_normal(a.n)
    # the fp64 cast stays out of the timed region
    b = np.ascontiguousarray(b, dtype=np.float64)
    if sym is None:
        t0 = time.perf_counter()
        sym = symbolic_cholesky(a)
        t_sym = time.perf_counter() - t0
    else:
        t_sym = 0.0
    t0 = time.perf_counter()
    f = multifrontal_cholesky(a, sym, relax=relax, backend=backend, pad=pad,
                              bs=bs, device=device)
    t_fac = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = multifrontal_solve(f, b, mode=sweep, sweep_bs=sweep_bs, rt=rt)
    t_sol = time.perf_counter() - t0
    resid = float(np.linalg.norm(a.matvec(x) - b)
                  / max(np.linalg.norm(b), 1e-30))
    return dict(time=t_sym + t_fac + t_sol, t_symbolic=t_sym, t_factor=t_fac,
                t_solve=t_sol, residual=resid, **f.stats)
