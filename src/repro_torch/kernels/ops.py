"""Port of ``repro/kernels/ops.py``: the attention entry point
``attention`` (:49) over the flash-attention kernel, the block-size policy
(``pick_block_size`` :144, capped at the kernels' 32 columns, and
``rhs_tile`` :248, copied) and the wrappers the
solver calls: ``matmul_nt_padded`` (:74), the per-front ``frontal_factor``
(:87) over the three tile kernels, ``frontal_factor_batch_ws`` (:164),
``extend_add_batch`` (:192) with ``extend_add_routed`` (the pipelined
factor's one launch per destination bucket), ``frontal_factor_batch`` (:206),
``tri_solve_batch`` (:258), ``sweep_forward`` and ``sweep_backward``
(:283-334), and ``spmv`` (:337).

There is no jit cache here: PyTorch runs eagerly, and the kernels take their
shapes at run time. The device follows the tensors (see
:mod:`repro_torch.kernels.frontal_cholesky`). Around ``tri_solve_batch`` the
sweeps gather, scatter and apply the ``L21`` coupling with torch ops
(``index_select``, ``bmm``, ``index_add_``). ``index_add_`` on CUDA adds with
atomics in no fixed order, so a device sweep is reproducible only to f32
rounding (about 1e-6 relative), not bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device, to_device
from . import frontal_cholesky as fc
from .flash_attention import FlashAttentionFn, check_bwd, uses_stats
from .spmv_bell import bell_spmv, csr_to_bell

__all__ = ["attention", "pick_block_size", "rhs_tile", "matmul_nt_padded",
           "front_workspace", "frontal_factor", "frontal_factor_batch_ws",
           "extend_add_batch", "extend_add_routed", "frontal_factor_batch",
           "tri_solve_batch",
           "sweep_forward", "sweep_backward", "spmv"]

#: widest RHS tile one tri-solve block holds (the kernel's limit)
MAX_RHS_TILE = 32


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """GQA flash attention. q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D).

    The reference repeated the kv heads to match the q heads and padded
    both sequences to its block sizes (``block_q``/``block_kv``) before the
    Pallas kernel; :func:`~repro_torch.kernels.flash_attention.flash_attention`
    maps query head h to kv head h // (Hq / Hkv) and masks ragged lengths
    itself, so this is a direct call and the block sizes are the kernel's
    own. The call goes through
    :class:`~repro_torch.kernels.flash_attention.FlashAttentionFn`, so a
    gradient through it launches the backward kernel, and a call whose
    gradient that kernel refuses raises ``ValueError`` before the forward
    launches; under ``torch.no_grad()`` only the forward runs. Where the
    gradient runs from the forward's statistics (bfloat16 at D = 64 or
    128 on the card), the forward stores them when a gradient will be
    taken, and never when serving."""
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if grad:
        check_bwd(q, k, causal)
    return FlashAttentionFn.apply(q, k, v, causal, grad and uses_stats(q))


def pick_block_size(npiv: int, bs: int | None = None) -> int:
    """Largest panel width ≤ ``bs`` (default 32) that divides ``npiv``.

    Bucketed pivot dims are multiples of 8 (pow2 ≥ 8 under the default pad
    policy, next-multiple-of-8 under ``mult8``), so the descent over
    divisors terminates at 8 at the latest; tiny fronts (npiv < 8) run
    unblocked. 32 keeps the sequential chol-tile loop short while the
    rank-bs updates stay matmul-shaped.

    Unlike the reference, the cap is itself capped at
    :data:`~repro_torch.kernels.frontal_cholesky.MAX_PANEL` (32), the widest
    panel the kernels take: a ``bs`` of 64 gives the panels of 32. The
    panel split changes only the rounding of the factor."""
    cap = fc.MAX_PANEL if bs is None else min(fc.MAX_PANEL, max(1, int(bs)))
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


def matmul_nt_padded(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, *,
                     alpha: float = 1.0, beta: float = 1.0) -> torch.Tensor:
    """``beta·c + alpha·a bᵀ`` for any shapes. The reference zero-padded to
    whole tiles; the CUDA kernel masks its ragged edge tiles instead, so
    nothing is padded here."""
    return fc.matmul_nt(a, b, c, alpha=alpha, beta=beta)


def front_workspace(f, npiv: int, P: int, R: int) -> torch.Tensor:
    """The padded f32 workspace of the front ``f`` (m, m), or of each front
    of a (B, m, m) stack, on ``f``'s device: (..., P + R, P + R) holding the
    lower triangle of the pivot block, identity columns padding it to ``P``
    (decoupled: they factor to 1 and contribute nothing), the coupling
    block and the lower triangle of the update block, in ``R ≥ m − npiv``
    rows."""
    f = torch.as_tensor(f, dtype=torch.float32)
    nrest = f.shape[-1] - npiv
    W = f.new_zeros(f.shape[:-2] + (P + R, P + R))
    W[..., :npiv, :npiv] = torch.tril(f[..., :npiv, :npiv])
    W.diagonal(dim1=-2, dim2=-1)[..., npiv:P] = 1.0
    if nrest:
        W[..., P : P + nrest, :npiv] = f[..., npiv:, :npiv]
        W[..., P : P + nrest, P : P + nrest] = torch.tril(f[..., npiv:, npiv:])
    return W


def frontal_factor(f, npiv: int, *, bs: int = 128
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial Cholesky of a frontal matrix (the lower triangle of ``f`` is
    read), on ``f``'s device: returns ``(L11, L21, S)`` as the reference's
    ``partial_cholesky_ref``, with ``S`` symmetrized from its lower
    triangle.

    The workspace is :func:`front_workspace`, its pivot block and update
    rows padded to multiples of ``bs``, so every tile is ``bs`` square.
    Per panel of ``bs`` columns: ``chol_tile`` of the
    diagonal tile, ``tri_inv_tile`` of its factor, the panel
    ``L21 = W21 L11⁻ᵀ`` by ``matmul_nt`` into a new tensor, then the
    trailing update ``S −= L21 L21ᵀ`` by ``matmul_nt`` in place on the
    workspace (its columns are disjoint from the panel's).
    """
    nrest = f.shape[0] - npiv
    P = -(-npiv // bs) * bs
    W = front_workspace(f, npiv, P, -(-nrest // bs) * bs)
    M = W.shape[0]
    for lo in range(0, P, bs):
        hi = lo + bs
        ltt = fc.chol_tile(W[lo:hi, lo:hi])
        W[lo:hi, lo:hi] = ltt
        if hi == M:
            continue
        inv = fc.tri_inv_tile(ltt)
        panel = W[hi:, lo:hi]
        lpanel = fc.matmul_nt(panel, inv, torch.zeros_like(panel),
                              alpha=1.0, beta=0.0)
        panel.copy_(lpanel)
        trail = W[hi:, hi:]
        fc.matmul_nt(lpanel, lpanel, trail, alpha=-1.0, beta=1.0, out=trail)

    L11 = torch.tril(W[:npiv, :npiv])
    L21 = W[P : P + nrest, :npiv]
    S = W[P : P + nrest, P : P + nrest]
    S = torch.tril(S) + torch.tril(S, -1).T  # the lower triangle is kept
    return L11, L21, S


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


def extend_add_routed(w: torch.Tensor, us, offs,
                      routing: fc.ExtendAddRouting, d: int) -> torch.Tensor:
    """Destination ``d`` of an uploaded extend-add routing, in place on
    ``w`` (see
    :func:`repro_torch.kernels.frontal_cholesky.extend_add_routed`)."""
    return fc.extend_add_routed(w, us, offs, routing, d)


def frontal_factor_batch(fs, npiv: int, *, bs: int | None = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched analogue of :func:`frontal_factor` for a uniform (B, m, m)
    stack of SPD fronts sharing one pivot count, on the stack's device.
    Pads the pivot block with decoupled identity columns (to a power of two
    ≥ 8 when ``bs`` is None, else to a multiple of ``bs``), factors the
    stack with one ``frontal_factor_batch`` call and returns (L11, L21, S)
    of shapes (B, npiv, npiv), (B, m − npiv, npiv), (B, m − npiv, m − npiv).
    """
    fs = torch.as_tensor(fs, dtype=torch.float32)
    nrest = fs.shape[-1] - npiv
    if bs is None:
        P = max(8, 1 << (npiv - 1).bit_length())
        bs = pick_block_size(P)
    else:
        P = -(-npiv // bs) * bs
    W = frontal_factor_batch_ws(front_workspace(fs, npiv, P, nrest), P,
                                bs=bs)
    L11 = torch.tril(W[:, :npiv, :npiv])
    L21 = W[:, P:, :npiv]
    S = W[:, P:, P:]
    S = torch.tril(S) + torch.tril(S, -1).transpose(1, 2)
    return L11, L21, S


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


def spmv(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
         x: np.ndarray, *, bs: int = 8, device=None) -> np.ndarray:
    """CSR SpMV through the block-ELL kernel in f32, as the reference: the
    layout is converted on the host, the product runs on ``device``
    (``None`` → CUDA; ``"cpu"`` runs the plain version)."""
    dev = resolve_device(device)
    n = x.shape[0]
    blocks, idx, npad = csr_to_bell(indptr, indices, data, n, bs)
    xp = np.zeros(npad, dtype=np.float32)
    xp[:n] = x
    y = bell_spmv(to_device(blocks.astype(np.float32), dev),
                  to_device(idx, dev), to_device(xp, dev))
    return y.cpu().numpy()[:n]
