"""Port of ``repro/core/plan.py``: ``ExecutionPlan`` (:39),
``PlanBuilder.build`` (:111) and ``execute_plan`` (:235), with
``matrix_fingerprint`` copied from ``repro/core/plan_cache.py``.

An :class:`ExecutionPlan` carries everything that is a pure function of the
sparsity structure — algorithm name, permutation, symbolic factor, predicted
cost — so executing it only applies the permutation and runs the numeric
phase. This slice builds plans for a named algorithm (no selector and no
plan cache yet) and executes them on the pipelined multifrontal backend with
device sweeps and fp64 refinement (``backend="pipelined"``,
``sweep="device"``). Request contexts and the metrics registry wait for the
engine slice; the solve-stage spans are returned in the result dict.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Dict, Optional

import numpy as np

from ..device import resolve_device
from ..sparse.csr import CSRMatrix, permute_symmetric
from ..sparse.multifrontal import multifrontal_cholesky, multifrontal_solve
from ..sparse.refine import refine_solve_device
from ..sparse.reorder import get_reordering
from ..sparse.symbolic import SymbolicFactor, symbolic_cholesky

__all__ = ["ExecutionPlan", "PlanBuilder", "execute_plan", "SOLVE_STAGES",
           "matrix_fingerprint"]


def matrix_fingerprint(a: CSRMatrix) -> str:
    """Structure fingerprint: n, nnz, and a hash of the CSR index buffers.

    Values (``a.data``) are deliberately excluded — ordering depends only on
    the pattern, so numerically-different instances of one structure share
    a plan.
    """
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(a.n).tobytes())
    h.update(np.int64(a.nnz).tobytes())
    h.update(np.ascontiguousarray(a.indptr, dtype=np.int32).tobytes())
    h.update(np.ascontiguousarray(a.indices, dtype=np.int32).tobytes())
    return h.hexdigest()


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
    """reorder → permute → symbolic on the host, for a named algorithm
    (the selector and the plan cache join in the selection slice)."""

    def build(self, a: CSRMatrix, algorithm: str,
              fingerprint: Optional[str] = None) -> ExecutionPlan:
        """Build a plan from scratch. ``meta`` records ``t_build`` and its
        ``t_reorder`` / ``t_symbolic`` split."""
        if algorithm is None:
            raise ValueError("no algorithm given; selection is not ported yet")
        t0 = time.perf_counter()
        perm = get_reordering(algorithm)(a)
        t_reorder = time.perf_counter() - t0
        pa = permute_symmetric(a, perm)
        sym = symbolic_cholesky(pa)
        dt = time.perf_counter() - t0
        return ExecutionPlan(
            fingerprint or matrix_fingerprint(a), algorithm,
            np.asarray(perm, dtype=np.int64), sym, sym.flops,
            meta=dict(t_build=dt, t_reorder=t_reorder,
                      t_symbolic=dt - t_reorder, t_select=0.0))


#: solve-stage names: the reference's spans, plus ``factor.schedule``
#: (supernodes, level schedule, extend-add routing) and ``solve.setup``
#: (block-ELL conversion of A and uploads for the refinement loop)
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
                 device=None) -> dict:
    """Numeric factor + solve of ``A x = b`` driven by the plan, on
    ``device`` (``None`` → CUDA, raising when there is none; ``"cpu"``
    runs the plain versions of the kernels).

    The only structure work left is applying the stored permutation; the
    symbolic factor is consumed as-is. ``solve_dtype`` is ``fp32`` (f32
    factor and sweeps) or ``fp32_refine`` (plus fp64 iterative refinement,
    device-resident); ``fp64`` is promoted to ``fp32_refine`` because the
    factor and the sweeps run in f32. ``pad``/``bs`` are the bucket pad
    policy and panel cap, ``sweep_bs``/``rt`` the sweep knobs. ``b`` may be
    ``(n,)`` or ``(n, k)``. The effective precision and policy land in the
    result dict and in ``plan.meta``; ``spans`` holds the times of the
    :data:`SOLVE_STAGES` in seconds.
    """
    if a.data is None:
        raise ValueError("numeric execution needs values")
    if solve_dtype not in ("fp64", "fp32", "fp32_refine"):
        raise ValueError(f"unknown solve_dtype {solve_dtype!r}")
    if solver != "multifrontal":
        raise ValueError(f"solver {solver!r} is not ported; the port has "
                         f"solver='multifrontal'")
    if sweep != "device":
        raise ValueError(f"sweep {sweep!r} is not ported; the port has "
                         f"sweep='device'")
    dev = resolve_device(device)
    if b is None:
        b = np.random.default_rng(0).standard_normal(a.n)
    perm = plan.perm
    t0 = time.perf_counter()
    pa = permute_symmetric(a, perm)
    t_perm = time.perf_counter() - t0

    refine_info = None
    # the factor and the sweeps run in f32
    eff_dtype = "fp32_refine" if solve_dtype == "fp64" else solve_dtype
    t0 = time.perf_counter()
    f = multifrontal_cholesky(pa, sym=plan.sym, backend=backend, pad=pad,
                              bs=bs, device=dev)
    fstats = f.stats
    t_fac = time.perf_counter() - t0
    t0 = time.perf_counter()
    pb = np.ascontiguousarray(b[perm], dtype=np.float64)
    if eff_dtype == "fp32_refine":
        z, refine_info = refine_solve_device(pa, f, pb, sweep_bs=sweep_bs,
                                             rt=rt)
    else:
        z = multifrontal_solve(f, pb, mode=sweep, sweep_bs=sweep_bs, rt=rt)
    t_sol = time.perf_counter() - t0

    spans = {"permute": t_perm, "factor": t_fac, "solve": t_sol,
             "solve.sweep": t_sol,
             "factor.schedule": fstats["t_factor_schedule"],
             "factor.assemble": fstats["t_factor_assemble"],
             "factor.device": (fstats["t_factor_dispatch"]
                               + fstats["t_factor_sync"])}
    if refine_info is not None:
        spans["solve.sweep"] = refine_info.t_sweep
        spans["solve.refine"] = refine_info.t_residual
        spans["solve.setup"] = refine_info.t_setup
    x = np.empty_like(z)
    x[perm] = z
    resid = float(np.linalg.norm(a.matvec(x) - b)
                  / max(np.linalg.norm(b), 1e-30))
    plan.meta["solve_backend"] = backend
    plan.meta["solve_dtype"] = eff_dtype
    plan.meta["solve_bs"] = bs
    plan.meta["solve_pad"] = pad
    plan.meta["solve_sweep"] = sweep
    return dict(x=x, time=t_perm + t_fac + t_sol, t_permute=t_perm,
                t_factor=t_fac, t_solve=t_sol, residual=resid,
                algorithm=plan.algorithm, solver=solver,
                backend=backend, solve_dtype=eff_dtype, bs=bs, pad=pad,
                sweep=sweep, rt=rt,
                overlap_efficiency=fstats.get("overlap_efficiency"),
                refine_iterations=(None if refine_info is None
                                   else refine_info.iterations),
                refine_converged=(None if refine_info is None
                                  else refine_info.converged),
                nnz_L=plan.nnz_L, flops=plan.predicted_flops,
                device=str(dev), spans=spans)
