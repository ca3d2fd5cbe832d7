"""Port of ``repro/sparse/refine.py``: ``RefineInfo``, ``_should_stop``,
the host loop ``refine_solve`` (:79) and ``refine_solve_device`` (:146).

Mixed-precision iterative refinement [Wilkinson 1963; Carson & Higham
2018]: factor once in fp32, then recover working-precision accuracy with a
short residual-correction loop in fp64:

    x₀ = L⁻ᵀ L⁻¹ b           (fp32 factor, device sweeps)
    rᵢ = b − A xᵢ            (fp64 block-ELL SpMV kernel)
    xᵢ₊₁ = xᵢ + L⁻ᵀ L⁻¹ rᵢ

The loop stops at ``tol``, at ``max_iter``, or when progress stalls.
:func:`refine_solve` runs it on the host around caller-supplied ``matvec``
and ``solve`` closures (any backend, the host sweeps).
:func:`refine_solve_device` is the loop of ``sweep="device"``: x, r and
the factor stacks stay on the device; the only host↔device traffic per
iteration is the residual-norm scalar. The residual runs in torch float64,
so no x64 context is needed (the reference's device refinement ran in f32
on jax builds without ``jax.experimental.enable_x64``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..device import to_device
from ..kernels.spmv_bell import bell_spmv, csr_to_bell, pick_spmv_bs
from .multifrontal import _device_sweep_passes, sweep_device

__all__ = ["RefineInfo", "refine_solve", "refine_solve_device",
           "DEFAULT_TOL"]

DEFAULT_TOL = 1e-12
_STALL_FACTOR = 0.5   # require ≥ 2× residual reduction per sweep to continue


@dataclasses.dataclass
class RefineInfo:
    iterations: int          # correction sweeps applied (0 = first solve enough)
    residuals: List[float]   # relative residual after each evaluation
    converged: bool
    # where the solve-phase wall time went: triangular sweeps vs residual
    # evaluation (the residual timer includes the one scalar sync per
    # iteration, where queued sweep work completes), and the one-off set-up
    # (block-ELL conversion of A and uploads)
    t_sweep: float = 0.0
    t_residual: float = 0.0
    t_setup: float = 0.0

    @property
    def final_residual(self) -> float:
        return self.residuals[-1] if self.residuals else float("inf")


def _should_stop(residuals: List[float], tol: float, iters: int,
                 max_iter: int) -> Tuple[bool, bool]:
    """(stop, converged) under the shared stopping rules: tolerance
    reached, iteration budget spent, or progress stalled (conditioning
    beyond what low-precision corrections can fix)."""
    rel = residuals[-1]
    if rel <= tol:
        return True, True
    if iters >= max_iter:
        return True, False
    if len(residuals) >= 2 and rel > _STALL_FACTOR * residuals[-2]:
        return True, False
    return False, False


def refine_solve(matvec: Callable[[np.ndarray], np.ndarray],
                 solve: Callable[[np.ndarray], np.ndarray],
                 b: np.ndarray, *,
                 tol: float = DEFAULT_TOL,
                 max_iter: int = 10) -> tuple[np.ndarray, RefineInfo]:
    """Solve A x = b to fp64 accuracy on the host with a low-precision
    inner solver: ``matvec`` is the fp64 operator of A, ``solve`` the
    factorization's solve applied to an fp64 right-hand side. ``b`` may be
    ``(n,)`` or ``(n, k)`` (both closures must then take blocks; the
    residual norm is Frobenius over the block). Returns ``(x, RefineInfo)``;
    ``t_setup`` stays 0."""
    pc = time.perf_counter
    b = np.asarray(b, dtype=np.float64)
    nb = float(np.linalg.norm(b))
    if nb == 0.0:
        return np.zeros_like(b), RefineInfo(0, [0.0], True)
    t0 = pc()
    x = np.asarray(solve(b), dtype=np.float64)
    t_sweep = pc() - t0
    residuals: List[float] = []
    iters = 0
    t_res = 0.0
    while True:
        t0 = pc()
        r = b - np.asarray(matvec(x), dtype=np.float64)
        rel = float(np.linalg.norm(r)) / nb
        t_res += pc() - t0
        residuals.append(rel)
        stop, ok = _should_stop(residuals, tol, iters, max_iter)
        if stop:
            return x, RefineInfo(iters, residuals, ok, t_sweep, t_res)
        t0 = pc()
        x = x + np.asarray(solve(r), dtype=np.float64)
        t_sweep += pc() - t0
        iters += 1


def refine_solve_device(a, f, b: np.ndarray, *,
                        tol: float = DEFAULT_TOL, max_iter: int = 10,
                        sweep_bs: Optional[int] = None,
                        rt: Optional[int] = None,
                        spmv_bs: Optional[int] = None
                        ) -> tuple[np.ndarray, RefineInfo]:
    """Device-resident refinement for the ``sweep="device"`` solve path.

    ``a`` is the (permuted) fp64 :class:`repro_torch.sparse.csr.CSRMatrix`,
    ``f`` the :class:`~repro_torch.sparse.multifrontal.MultifrontalFactor`
    of any backend (the loop runs on its sweep device). The correction solve is the device sweep on
    the resident factor stacks, the residual matvec the block-ELL SpMV
    kernel over fp64 blocks (converted from CSR once), and the one
    per-iteration host↔device transfer is the residual-norm scalar — the
    ``float()`` that is also the sync point for the queued sweep.
    ``b``: ``(n,)`` or ``(n, k)``; returns ``(x fp64 host, RefineInfo)``.

    ``spmv_bs`` is the block size of that layout; ``None`` picks the one
    that stores the fewest bytes (:func:`pick_spmv_bs`). The reference
    fixes 8, which suits the TPU's (8, 128) tiling. On the card the kernel
    is bound by the bytes it reads, ELL padding included, and bs = 8 pads
    a 3-D mesh 24× over its CSR (bs = 1 stores about CSR's bytes), so the
    default differs; ``spmv_bs=8`` gives the reference's layout.
    """
    pc = time.perf_counter
    b = np.asarray(b, dtype=np.float64)
    single = b.ndim == 1
    b2 = b[:, None] if single else b
    n, k = b2.shape
    nb = float(np.linalg.norm(b2))
    if nb == 0.0:
        return np.zeros_like(b), RefineInfo(0, [0.0], True)
    device = sweep_device(f)
    t0 = pc()
    if spmv_bs is None:
        spmv_bs = pick_spmv_bs(a.indptr, a.indices, n)
    blocks, idx, npad = csr_to_bell(a.indptr, a.indices, a.data, n,
                                    bs=spmv_bs)
    blocks_d = to_device(blocks, device)                 # fp64 ELL blocks
    idx_d = to_device(idx, device)
    bp = torch.zeros((npad, k), dtype=torch.float64, device=device)
    bp[:n] = to_device(b2, device)

    def sweep(r32: torch.Tensor) -> torch.Tensor:
        """f32 sweep pass on a device (n, k) block → device (n, k) f32."""
        x = torch.zeros((n + 1, k), dtype=torch.float32, device=device)
        x[:n] = r32
        return _device_sweep_passes(f, x, sweep_bs=sweep_bs, rt=rt)[:n]

    t_setup = pc() - t0
    t0 = pc()
    x = torch.zeros((npad, k), dtype=torch.float64, device=device)
    x[:n] = sweep(bp[:n].float())
    t_sweep = pc() - t0
    residuals: List[float] = []
    iters = 0
    t_res = 0.0
    while True:
        t0 = pc()
        r = bp - bell_spmv(blocks_d, idx_d, x)
        rel = float(torch.linalg.vector_norm(r)) / nb  # the one scalar sync
        t_res += pc() - t0
        residuals.append(rel)
        stop, ok = _should_stop(residuals, tol, iters, max_iter)
        if stop:
            break
        t0 = pc()
        x[:n] += sweep(r[:n].float())
        t_sweep += pc() - t0
        iters += 1
    out = x[:n].cpu().numpy()
    return (out[:, 0] if single else out,
            RefineInfo(iters, residuals, ok, t_sweep, t_res, t_setup))
