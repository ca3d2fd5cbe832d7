"""Port of ``repro/core/plan.py``: ``ExecutionPlan`` (:39), ``PlanBuilder``
(:67) — ``build`` (:111), ``get_or_build`` (:140), ``select_names``
(:158), ``plan_batch`` (:196), ``stats`` — and ``execute_plan`` (:235).

An :class:`ExecutionPlan` carries everything that is a pure function of the
sparsity structure — algorithm name, permutation, symbolic factor, predicted
cost — so executing it only applies the permutation and runs the numeric
phase. :class:`PlanBuilder` composes ``ReorderSelector.select_batch``
(featurize + classify on the card), the reorderings and
``symbolic_cholesky`` into plans, front-ended by a
:class:`~repro_torch.core.plan_cache.PlanCache` (in memory) or
:class:`~repro_torch.core.plan_cache.TwoTierPlanCache` (memory over disk).
``execute_plan`` runs
every branch of the reference's (:302-345): the four multifrontal backends,
the four sweep modes, host or device fp64 refinement and the simplicial
solver; its defaults are the served path (``backend="pipelined"``,
``sweep="device"``, ``solve_dtype="fp32_refine"``).

For serving, as in the reference: a
:class:`~repro_torch.core.reqctx.RequestContext` passed as ``ctx`` gets the
spans ``cache`` (``get_or_build``), ``select``, ``reorder`` and ``symbolic``
(``build``) and the solve stages (``execute_plan``), whose factorization
checks its deadline between levels; a
:class:`~repro_torch.core.metrics.MetricsRegistry` passed as ``metrics``
gets ``infer.batches`` / ``infer.matrices`` / ``infer.batch_s`` and the
serving mesh's shard utilization per device micro-batch
(``select_names``), and ``stage.<name>`` histograms, ``solve.*`` counters
and gauges per solve (``execute_plan``). The solve-stage spans are also
returned in the result dict.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..device import resolve_device
from ..distributed.meshctx import get_serving_mesh, record_shard_utilization
from ..sparse.csr import CSRMatrix, permute_symmetric
from ..sparse.multifrontal import (DEVICE_BACKENDS, SWEEP_MODES,
                                   multifrontal_cholesky, multifrontal_solve)
from ..sparse.numeric import cholesky_solve, sparse_cholesky
from ..sparse.refine import refine_solve, refine_solve_device
from ..sparse.reorder import get_reordering
from ..sparse.symbolic import SymbolicFactor, symbolic_cholesky
from .plan_cache import PlanCache, matrix_fingerprint
from .reqctx import RequestContext

__all__ = ["ExecutionPlan", "PlanBuilder", "execute_plan", "SOLVE_STAGES",
           "matrix_fingerprint"]


@dataclasses.dataclass
class ExecutionPlan:
    """Everything structure-determined about solving one sparsity pattern.

    Valid for *any* matrix sharing ``fingerprint`` (values don't enter any
    field).
    """

    fingerprint: str
    algorithm: str              # reordering that produced `perm`
    perm: np.ndarray            # perm[new] = old (repro_torch.sparse.reorder convention)
    sym: SymbolicFactor         # symbolic analysis of the *permuted* pattern
    predicted_flops: int        # factorization cost model: sym.flops
    meta: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return int(self.perm.shape[0])

    @property
    def nnz_L(self) -> int:
        return self.sym.nnz_L

    @property
    def fill(self) -> int:
        return self.sym.fill


class PlanBuilder:
    """select → reorder → symbolic, cache-aware and batch-first.

    ``plan_batch`` is the serving entry point: fingerprints the request,
    answers repeats from the cache, runs the selector's device path once
    over the deduplicated misses, and builds and installs fresh plans.
    Counters expose how much work each stage did, so a warm hit can be shown
    to do no feature extraction, classification or symbolic analysis.
    ``device`` is where the device path featurizes and classifies
    (``None`` → CUDA). Thread-safe: the dispatcher's batcher, its build
    workers and RPC connection threads share one builder.
    """

    def __init__(self, selector=None, cache: Optional[PlanCache] = None, *,
                 path: str = "device", batch_size: int = 16, device=None,
                 metrics=None):
        self.selector = selector
        self.cache = cache if cache is not None else PlanCache()
        self.path = path
        self.batch_size = batch_size
        self.device = device
        self.metrics = metrics
        # stage counters; builds run concurrently in the dispatcher's worker
        # pool, so updates go through _count
        self._stats_lock = threading.Lock()
        self.plans_built = 0
        self.sym_builds = 0
        self.select_calls = 0
        self.select_seconds = 0.0
        self.build_seconds = 0.0

    def _count(self, **deltas) -> None:
        with self._stats_lock:
            for k, d in deltas.items():
                setattr(self, k, getattr(self, k) + d)

    def reset_stats(self) -> None:
        """Zero the stage counters (and the cache's, via its own reset)."""
        with self._stats_lock:
            self.plans_built = self.sym_builds = self.select_calls = 0
            self.select_seconds = self.build_seconds = 0.0
        self.cache.reset_stats()

    # -- single-matrix ------------------------------------------------------
    def build(self, a: CSRMatrix, algorithm: Optional[str] = None,
              fingerprint: Optional[str] = None,
              ctx: Optional[RequestContext] = None) -> ExecutionPlan:
        """Build a plan from scratch (no cache involvement); without an
        ``algorithm`` the selector picks one on the host. ``meta`` records
        ``t_select`` and ``t_build`` with its ``t_reorder`` / ``t_symbolic``
        split; a ``ctx`` gets the spans ``select``, ``reorder`` and
        ``symbolic``."""
        t_sel = 0.0
        if algorithm is None:
            if self.selector is None:
                raise ValueError("no algorithm given and no selector set")
            algorithm, t_sel = self.selector.select(a)
            self._count(select_calls=1, select_seconds=t_sel)
            if ctx is not None:
                ctx.add_span("select", t_sel)
        t0 = time.perf_counter()  # select_seconds and build_seconds are
        perm = get_reordering(algorithm)(a)  # disjoint stages in reports
        t_reorder = time.perf_counter() - t0
        pa = permute_symmetric(a, perm)
        sym = symbolic_cholesky(pa)
        dt = time.perf_counter() - t0
        if ctx is not None:
            ctx.add_span("reorder", t_reorder)
            ctx.add_span("symbolic", dt - t_reorder)
        self._count(sym_builds=1, plans_built=1, build_seconds=dt)
        return ExecutionPlan(
            fingerprint or matrix_fingerprint(a), algorithm,
            np.asarray(perm, dtype=np.int64), sym, sym.flops,
            meta=dict(t_build=dt, t_reorder=t_reorder,
                      t_symbolic=dt - t_reorder, t_select=t_sel))

    def get_or_build(self, a: CSRMatrix,
                     ctx: Optional[RequestContext] = None
                     ) -> Tuple[ExecutionPlan, bool]:
        """(plan, was_hit) for one matrix through the cache; a ``ctx`` gets
        its fingerprint and the ``cache`` span."""
        key = matrix_fingerprint(a)
        if ctx is not None:
            ctx.fingerprint = key
            with ctx.span("cache"):
                plan = self.cache.get(key)
        else:
            plan = self.cache.get(key)
        if plan is not None:
            return plan, True
        plan = self.build(a, fingerprint=key, ctx=ctx)
        self.cache.put(key, plan)
        return plan, False

    # -- batched serving path ------------------------------------------------
    def select_names(self, mats: Sequence[CSRMatrix]) -> List[str]:
        """Device-batched selection in size-tiered chunks of ``batch_size``.

        Partial device chunks are padded to ``batch_size`` (repeating a
        member) so the batch dim stays one shape bucket; filler results are
        dropped.
        """
        if self.selector is None:
            raise ValueError("PlanBuilder has no selector for cache misses")
        order = sorted(range(len(mats)), key=lambda i: (mats[i].nnz,
                                                        mats[i].n))
        names: List[Optional[str]] = [None] * len(mats)
        for lo in range(0, len(order), self.batch_size):
            chunk = order[lo : lo + self.batch_size]
            batch = [mats[i] for i in chunk]
            if self.path == "device":
                batch += [batch[0]] * (self.batch_size - len(chunk))
            got, dt = self.selector.select_batch(batch, path=self.path,
                                                 device=self.device)
            self._count(select_calls=1, select_seconds=dt)
            if self.metrics is not None:
                self.metrics.counter("infer.batches").inc()
                self.metrics.counter("infer.matrices").inc(len(chunk))
                self.metrics.histogram("infer.batch_s").observe(dt)
                if self.path == "device":
                    # live rows vs pad-filler of this batch on each shard
                    record_shard_utilization(
                        self.metrics, get_serving_mesh(self.device),
                        len(chunk), len(batch))
            for i, name in zip(chunk, got):
                names[i] = name
        return names  # type: ignore[return-value]

    def plan_batch(self, mats: Sequence[CSRMatrix]) -> List[ExecutionPlan]:
        """Plans for a request batch; hits skip select+reorder+symbolic."""
        keys = [matrix_fingerprint(m) for m in mats]
        plans: List[Optional[ExecutionPlan]] = [None] * len(mats)
        pending: Dict[str, List[int]] = {}
        for i, key in enumerate(keys):
            hit = self.cache.get(key)
            if hit is not None:
                plans[i] = hit
            else:
                pending.setdefault(key, []).append(i)
        if pending:
            miss_idx = [idxs[0] for idxs in pending.values()]
            names = self.select_names([mats[i] for i in miss_idx])
            for i, name in zip(miss_idx, names):
                plan = self.build(mats[i], algorithm=name,
                                  fingerprint=keys[i])
                self.cache.put(keys[i], plan)
                for j in pending[keys[i]]:
                    plans[j] = plan
        return plans  # type: ignore[return-value]

    def stats(self) -> dict:
        s = self.cache.stats()
        with self._stats_lock:
            s.update(plans_built=self.plans_built,
                     sym_builds=self.sym_builds,
                     select_calls=self.select_calls,
                     select_seconds=self.select_seconds,
                     build_seconds=self.build_seconds)
        return s


#: solve-stage names: the reference's spans, plus ``factor.schedule``
#: (supernodes, level schedule, extend-add routing) and ``solve.setup``
#: (block-ELL conversion of A and uploads for the device refinement loop).
#: A path records the stages it has: the served path all of them.
SOLVE_STAGES = ("permute", "factor", "factor.schedule", "factor.assemble",
                "factor.device", "solve", "solve.setup", "solve.sweep",
                "solve.refine")


def execute_plan(a: CSRMatrix, plan: ExecutionPlan,
                 b: Optional[np.ndarray] = None, *,
                 solver: str = "multifrontal",
                 backend: str = "pipelined",
                 solve_dtype: str = "fp32_refine",
                 pad: str = "pow2",
                 bs: Optional[int] = None,
                 sweep: str = "device",
                 sweep_bs: Optional[int] = None,
                 rt: Optional[int] = None,
                 device=None,
                 ctx: Optional[RequestContext] = None,
                 metrics=None) -> dict:
    """Numeric factor + solve of ``A x = b`` driven by the plan, on
    ``device`` (``None`` → CUDA, raising when there is none; ``"cpu"``
    runs the plain versions of the kernels).

    The only structure work left is applying the stored permutation; the
    symbolic factor is consumed as-is. ``solver`` is ``multifrontal`` or
    ``simplicial`` (host fp64, one RHS). ``backend`` picks the front math
    (host ``numpy``, per-front ``pallas``, level-scheduled ``batched``,
    ``pipelined``) and ``sweep`` the triangular sweeps (``auto`` →
    ``level``, ``seq``, ``level``, ``device``; see
    :func:`repro_torch.sparse.multifrontal.multifrontal_solve`).
    ``solve_dtype`` is ``fp64``, ``fp32`` or ``fp32_refine`` (f32 factor
    and/or sweeps plus fp64 iterative refinement: on the device with
    ``sweep="device"``, else on the host); as in the reference, ``fp64`` is
    promoted to ``fp32_refine`` when the backend or the sweeps run in f32.
    ``pad``/``bs`` are the bucket pad policy and panel cap,
    ``sweep_bs``/``rt`` the device sweep's knobs. ``b`` may be ``(n,)`` or
    ``(n, k)``. The effective precision, sweep and policy land in the result
    dict and in ``plan.meta``; ``spans`` holds the times of the
    :data:`SOLVE_STAGES` the path has, in seconds.

    A ``ctx`` gets those spans and rides into the factorization, which
    raises :class:`~repro_torch.core.reqctx.DeadlineExceeded` at a level
    boundary once its deadline has passed. A ``metrics`` registry gets a
    ``stage.<name>`` histogram per span, the ``solve.overlap_efficiency``
    gauge of the device backends, ``solve.requests`` and
    ``solve.sweep.<mode>`` counters and, on the refined paths, the
    ``solve.refine_iterations`` histogram and ``solve.refine_iters.<i>``
    counters (``i`` capped at 8).
    """
    if a.data is None:
        raise ValueError("numeric execution needs values")
    if solve_dtype not in ("fp64", "fp32", "fp32_refine"):
        raise ValueError(f"unknown solve_dtype {solve_dtype!r}")
    if sweep not in SWEEP_MODES:
        raise ValueError(f"unknown sweep {sweep!r}")
    if solver not in ("multifrontal", "simplicial"):
        raise ValueError(f"unknown solver {solver!r}")
    dev = resolve_device(device)
    if b is None:
        b = np.random.default_rng(0).standard_normal(a.n)
    perm = plan.perm
    t0 = time.perf_counter()
    pa = permute_symmetric(a, perm)
    t_perm = time.perf_counter() - t0

    refine_info = None
    eff_dtype, eff_sweep = solve_dtype, sweep
    fstats: dict = {}
    t0 = time.perf_counter()
    if solver == "multifrontal":
        if (backend in DEVICE_BACKENDS or sweep == "device") \
                and solve_dtype == "fp64":
            eff_dtype = "fp32_refine"  # f32 factor and/or f32 sweeps
        f = multifrontal_cholesky(
            pa, sym=plan.sym, backend=backend,
            dtype=np.float64 if eff_dtype == "fp64" else np.float32,
            pad=pad, bs=bs, device=dev, ctx=ctx)
        fstats = f.stats
        t_fac = time.perf_counter() - t0
        t0 = time.perf_counter()
        if eff_sweep == "auto":
            eff_sweep = "level"
        pb = np.ascontiguousarray(b[perm], dtype=np.float64)
        if eff_dtype == "fp32_refine" and eff_sweep == "device":
            z, refine_info = refine_solve_device(pa, f, pb,
                                                 sweep_bs=sweep_bs, rt=rt)
        elif eff_dtype == "fp32_refine":
            z, refine_info = refine_solve(
                pa.matvec,
                lambda r: multifrontal_solve(f, r, mode=eff_sweep), pb)
        else:
            z = multifrontal_solve(f, pb, mode=eff_sweep, sweep_bs=sweep_bs,
                                   rt=rt)
    else:
        eff_dtype, eff_sweep = "fp64", "seq"  # host fp64 only
        fac = sparse_cholesky(pa, sym=plan.sym)
        t_fac = time.perf_counter() - t0
        t0 = time.perf_counter()
        z = cholesky_solve(fac, b[perm])
    t_sol = time.perf_counter() - t0

    spans = {"permute": t_perm, "factor": t_fac, "solve": t_sol,
             "solve.sweep": t_sol}
    if "t_factor_schedule" in fstats:
        spans["factor.schedule"] = fstats["t_factor_schedule"]
    if "t_factor_assemble" in fstats:
        spans["factor.assemble"] = fstats["t_factor_assemble"]
        spans["factor.device"] = (fstats["t_factor_dispatch"]
                                  + fstats["t_factor_sync"])
    if refine_info is not None:
        spans["solve.sweep"] = refine_info.t_sweep
        spans["solve.refine"] = refine_info.t_residual
        if eff_sweep == "device":
            spans["solve.setup"] = refine_info.t_setup
    if ctx is not None:
        for stage, dt in spans.items():
            ctx.add_span(stage, dt)
    if metrics is not None:
        for stage, dt in spans.items():
            metrics.histogram(f"stage.{stage}").observe(dt)
        if "overlap_efficiency" in fstats:
            metrics.gauge("solve.overlap_efficiency").set(
                fstats["overlap_efficiency"])
        metrics.counter("solve.requests").inc()
        metrics.counter(f"solve.sweep.{eff_sweep}").inc()
        if refine_info is not None:
            metrics.histogram("solve.refine_iterations").observe(
                float(refine_info.iterations))
            metrics.counter(
                f"solve.refine_iters.{min(refine_info.iterations, 8)}").inc()
    x = np.empty_like(z)
    x[perm] = z
    resid = float(np.linalg.norm(a.matvec(x) - b)
                  / max(np.linalg.norm(b), 1e-30))
    plan.meta["solve_backend"] = backend
    plan.meta["solve_dtype"] = eff_dtype
    plan.meta["solve_bs"] = bs
    plan.meta["solve_pad"] = pad
    plan.meta["solve_sweep"] = eff_sweep
    return dict(x=x, time=t_perm + t_fac + t_sol, t_permute=t_perm,
                t_factor=t_fac, t_solve=t_sol, residual=resid,
                algorithm=plan.algorithm, solver=solver,
                backend=backend, solve_dtype=eff_dtype, bs=bs, pad=pad,
                sweep=eff_sweep, rt=rt,
                overlap_efficiency=fstats.get("overlap_efficiency"),
                refine_iterations=(None if refine_info is None
                                   else refine_info.iterations),
                refine_converged=(None if refine_info is None
                                  else refine_info.converged),
                nnz_L=plan.nnz_L, flops=plan.predicted_flops,
                device=str(dev), spans=spans,
                request_id=None if ctx is None else ctx.request_id)
