"""Port of ``repro/kernels/ops.py``: the block-size policy
(``pick_block_size`` :144, ``rhs_tile`` :248, copied) and the wrappers the
solver calls, ``frontal_factor_batch_ws`` (:164), ``extend_add_batch``
(:192), ``tri_solve_batch`` (:258), ``sweep_forward`` and
``sweep_backward`` (:283-334).

There is no jit cache here: PyTorch runs eagerly, and the kernels take their
shapes at run time. The device follows the tensors (see
:mod:`repro_torch.kernels.frontal_cholesky`). Around ``tri_solve_batch`` the
sweeps gather, scatter and apply the ``L21`` coupling with torch ops
(``index_select``, ``bmm``, ``index_add_``). ``index_add_`` on CUDA adds with
atomics in no fixed order, so a device sweep is reproducible only to f32
rounding (about 1e-6 relative), not bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import frontal_cholesky as fc

__all__ = ["pick_block_size", "rhs_tile", "frontal_factor_batch_ws",
           "extend_add_batch", "tri_solve_batch", "sweep_forward",
           "sweep_backward"]

#: widest RHS tile one tri-solve block holds (the kernel's limit)
MAX_RHS_TILE = 32


def pick_block_size(npiv: int, bs: int | None = None) -> int:
    """Largest panel width ≤ ``bs`` (default 32) that divides ``npiv``.

    Bucketed pivot dims are multiples of 8 (pow2 ≥ 8 under the default pad
    policy, next-multiple-of-8 under ``mult8``), so the descent over
    divisors terminates at 8 at the latest; tiny fronts (npiv < 8) run
    unblocked. 32 keeps the sequential chol-tile loop short while the
    rank-bs updates stay matmul-shaped."""
    cap = 32 if bs is None else max(1, int(bs))
    if npiv <= cap:
        return npiv
    for cand in range(cap, 0, -1):
        if npiv % cand == 0:
            return cand
    return npiv


def rhs_tile(k: int, rt: int | None = None) -> int:
    """Effective RHS-tile width: ``rt`` when it divides the RHS count,
    else the whole slab (one tile). The autotuned ``rt`` policy knob only
    kicks in when the caller's padded RHS width actually tiles by it."""
    if rt is None or k <= 0:
        return max(k, 1)
    rt = max(1, int(rt))
    return rt if k % rt == 0 else k


def _kernel_tile(k: int, rt: Optional[int]) -> int:
    """RHS tile of one tri-solve block: ``rhs_tile`` capped at the kernel's
    limit (the kernel masks a ragged last tile)."""
    return min(rhs_tile(k, rt), MAX_RHS_TILE)


def frontal_factor_batch_ws(w: torch.Tensor, npiv: int, *,
                            bs: int | None = None) -> torch.Tensor:
    """Factor the leading ``npiv`` columns of every (M, M) front workspace
    of the (B, M, M) stack ``w`` in place, in one kernel call. ``bs`` is a
    cap on the panel width; the width used is the largest divisor of
    ``npiv`` not exceeding it (see
    :func:`repro_torch.kernels.frontal_cholesky.frontal_factor_batch`)."""
    return fc.frontal_factor_batch(w, npiv, bs=pick_block_size(npiv, bs))


def extend_add_batch(w: torch.Tensor, u: torch.Tensor, dst, rows, *,
                     src=None, off: int = 0) -> torch.Tensor:
    """On-device extend-add in place on ``w`` (see
    :func:`repro_torch.kernels.frontal_cholesky.extend_add_batch`)."""
    return fc.extend_add_batch(w, u, dst, rows, src=src, off=off)


def tri_solve_batch(l: torch.Tensor, x: torch.Tensor, *,
                    bs: int | None = None, rt: int | None = None,
                    lower: bool = True) -> torch.Tensor:
    """Batched blocked triangular substitution: returns ``Y`` with
    ``L Y = X`` (``lower``) or ``Lᵀ Y = X`` for ``l`` (B, P, P) and ``x``
    (B, P, K); ``x`` is left as it was. ``bs`` caps the panel width,
    ``rt`` tiles the RHS dim."""
    y = x.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
    return fc.tri_solve_batch(l, y, bs=pick_block_size(l.shape[1], bs),
                              kt=_kernel_tile(y.shape[2], rt), lower=lower)


def sweep_forward(x: torch.Tensor, l11: torch.Tensor, l21: torch.Tensor,
                  piv: torch.Tensor, rest: torch.Tensor, *,
                  bs: int | None = None, rt: int | None = None
                  ) -> torch.Tensor:
    """One level-bucket's forward-substitution step, in place on the
    (n + 1, K) f32 solution block ``x`` whose last row is the trash row
    every pad index points at. Gathers the bucket's pivot rows, solves
    ``L11 y = x`` with the batched kernel, scatters ``y`` back and
    subtracts the ``L21 y`` updates from the update rows. Returns ``x``."""
    (B, P), k = piv.shape, x.shape[1]
    y = x.index_select(0, piv.reshape(-1)).view(B, P, k)
    fc.tri_solve_batch(l11, y, bs=pick_block_size(P, bs),
                       kt=_kernel_tile(k, rt), lower=True)
    x.index_copy_(0, piv.reshape(-1), y.view(-1, k))
    if l21.shape[1]:
        upd = torch.bmm(l21, y)
        x.index_add_(0, rest.reshape(-1), upd.view(-1, k), alpha=-1)
    return x


def sweep_backward(x: torch.Tensor, l11: torch.Tensor, l21: torch.Tensor,
                   piv: torch.Tensor, rest: torch.Tensor, *,
                   bs: int | None = None, rt: int | None = None
                   ) -> torch.Tensor:
    """One level-bucket's backward-substitution step (``Lᵀ x = y``), in
    place on ``x``: gathers pivot and update rows, subtracts the ``L21ᵀ``
    coupling, runs the batched upper solve and scatters the pivots back."""
    (B, P), k = piv.shape, x.shape[1]
    rhs = x.index_select(0, piv.reshape(-1)).view(B, P, k)
    if l21.shape[1]:
        xr = x.index_select(0, rest.reshape(-1)).view(B, -1, k)
        rhs -= torch.bmm(l21.transpose(1, 2), xr)
    fc.tri_solve_batch(l11, rhs, bs=pick_block_size(P, bs),
                       kt=_kernel_tile(k, rt), lower=False)
    x.index_copy_(0, piv.reshape(-1), rhs.view(-1, k))
    return x

