"""Port of ``repro/kernels/flash_attention.py`` (``flash_attention``,
``pallas_call`` at :91) as hand-written CUDA kernels, with their plain
PyTorch version beside them: the reference's oracle
``repro/kernels/ref.py::attention_ref`` (:11-28). bfloat16 at D = 64 and
128 (the served models' head dims) runs the Hopper kernel of
``csrc/flash_attention_sm90.cu`` (TMA ring, wgmma, warp specialization);
bfloat16 at D = 16 and 32 and float32 run ``csrc/flash_attention.cu``.

Both take the grouped-query layout of the model: q (B, Hq, Sq, D) and k/v
(B, Hkv, Skv, D) with Hq a multiple of Hkv; query head h reads key/value
head h // (Hq / Hkv). The reference's ``ops.attention`` repeated the key and
value heads and padded both sequences to block multiples before its kernel;
the CUDA kernel maps the heads itself and masks ragged lengths, so neither
copy is made.

The function is the Pallas kernel's: scores q·kᵀ · sm_scale in float32
(sm_scale = D^-½ by default), keys at or past ``kv_len`` and, when
``causal``, keys past the query's position (qpos ≥ kpos, both counted from
0) set to −1e30 (never −inf, so a fully masked row gives a finite mean of V
rather than NaN), softmax with its sum floored at 1e-30, P·V with P in
float32, and the output in q's dtype. Inputs are bfloat16 or float32; the
head dim D is 16, 32, 64 or 128.

The wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises, and counts its launches in
``flash_attention.launches``. The kernels read their operands in place, so
each must have a layout they can address: :func:`operand_error` is that
rule.

The gradient. The reference has no ``custom_vjp`` around its kernel: its
model trains through the XLA twin, which XLA differentiates. Here training
launches the forward kernel, so :class:`FlashAttentionFn` gives it a
backward: :func:`flash_attention_bwd`, whose plain version
:func:`flash_attention_bwd_plain` is ``torch.autograd.grad`` through
:func:`flash_attention_plain`. It takes what training needs, causal
attention with as many keys as queries and no ``kv_len``, in float32 or
bfloat16 at every head dim of the forward, and refuses the rest with
``ValueError`` on every device. On the card, bfloat16 at the head dims of
:data:`STATS_DIMS` runs ``csrc/flash_attention_bwd_sm90.cu`` (two wgmma
kernels fed by TMA: dQ with each row's D, then dK and dV) from the
forward's statistics: the rows' log-sum-exp and the output's bf16
remainder, which :func:`flash_attention` returns with ``stats=True`` and
:class:`FlashAttentionFn` saves. Float32 and D = 16 / 32 run the first
design, ``csrc/flash_attention_bwd.cu`` (two kernels, dQ with the rows'
statistics rebuilt, then dK and dV). Either way one wrapper call is two
kernel launches, counted as one in ``flash_attention_bwd.launches``.

The dry run (:mod:`repro_torch.launch.dryrun`) passes meta tensors, which
:func:`~repro_torch.device.on_cuda` sends down the card's branch there:
both wrappers check them as on the card, then apply their shape rule (the
outputs as the kernels lay them out, no storage) and launch nothing, so no
build is triggered and no launch counted. Either way each call tells the
operation count its work (:func:`~repro_torch.kernels._build.note_work`):
4·D flops a (query, key) pair the mask keeps for the forward, 10·D for the
backward (PERF.md's bounds for rows 10 and 10b), and the bytes of its
operands and results.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import on_cuda
from ._build import count_launch, load_kernels, note_work

__all__ = ["flash_attention", "flash_attention_plain", "operand_error",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "FlashAttentionFn", "check_bwd", "uses_stats", "lse_rows",
           "STATS_DIMS", "NEG_INF"]

NEG_INF = -1e30

#: head dims at which bf16 training runs the Hopper backward from the
#: forward's statistics (the wgmma forward stores them at D = 64 and 128)
STATS_DIMS = (64, 128)


def _pairs(sq: int, skv: int, causal: bool, kv_len: Optional[int]) -> int:
    """The (query, key) pairs the mask keeps: keys below ``kv_len`` and,
    when ``causal``, at or before the query's position."""
    n = skv if kv_len is None else max(0, min(skv, kv_len))
    if not causal:
        return sq * n
    m = min(sq, n)
    return m * (m + 1) // 2 + (sq - m) * n


def _nbytes(*ts: Optional[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}: same B and D, and Hq a multiple "
                         f"of Hkv")
    if not (q.dtype == k.dtype == v.dtype
            and q.dtype in (torch.float32, torch.bfloat16)):
        raise TypeError(f"q, k, v must share dtype float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")


def operand_error(t: torch.Tensor) -> Optional[str]:
    """Why the CUDA kernels cannot read the (B, H, S, D) tensor ``t`` in
    place, or None if they can. The rule is TMA's, through which the bf16
    kernel loads: a unit stride along D; batch, head and sequence strides
    that are multiples of 16 bytes (a dim of extent 1 never moves, so its
    stride does not count); storage that starts on a 16-byte boundary. Any
    contiguous tensor and the model's head-transposed views pass."""
    if t.dim() != 4:
        return f"want (B, H, S, D), got shape {tuple(t.shape)}"
    if t.stride(3) != 1:
        return f"stride {t.stride(3)} along D, want 1"
    size = t.element_size()
    for dim, name in ((2, "sequence"), (1, "head"), (0, "batch")):
        if t.shape[dim] > 1 and t.stride(dim) * size % 16:
            return (f"{name} stride of {t.stride(dim) * size} bytes, want a "
                    f"multiple of 16")
    if t.data_ptr() % 16:
        return (f"storage starts {t.data_ptr() % 16} bytes past a 16-byte "
                f"boundary")
    return None


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          sm_scale: Optional[float] = None,
                          kv_len: Optional[int] = None, stats: bool = False):
    """Plain version: ``attention_ref`` over the grouped heads, the whole
    (Sq, Skv) score matrix in float32 at once. With ``stats``, returns
    (out, lse, out_lo): the rows' log-sum-exp of the masked scores, float32
    (B, Hq, Sq), and the output's remainder, the float32 output less
    ``out``, in q's dtype (zeros in float32)."""
    _check(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if sm_scale is None else sm_scale
    qg = q.float().reshape(b, hkv, hq // hkv * sq, d)
    s = torch.matmul(qg, k.float().transpose(-1, -2)) * scale
    s = s.view(b, hkv, hq // hkv, sq, skv)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    if kv_len is not None:
        mask &= kpos[None, :] < kv_len
    if causal:
        mask &= torch.arange(sq, device=q.device)[:, None] >= kpos[None, :]
    s = torch.where(mask, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1).view(b, hq, sq) if stats else None
    p = torch.softmax(s, dim=-1).view(b, hkv, hq // hkv * sq, skv)
    out = torch.matmul(p, v.float()).view(b, hq, sq, d)
    if not stats:
        return out.to(q.dtype)
    hi = out.to(q.dtype)
    return hi, lse, (out - hi.float()).to(q.dtype)


def uses_stats(q: torch.Tensor) -> bool:
    """Whether the backward of attention over ``q`` runs from the forward's
    statistics on the card: bfloat16 at a head dim of :data:`STATS_DIMS`."""
    return q.dtype == torch.bfloat16 and q.shape[-1] in STATS_DIMS


def lse_rows(s: int) -> int:
    """Rows of the card's log-sum-exp storage for S rows: S rounded up to
    128, the kernels' tile of rows, so each tile's reads stay inside it."""
    return -(-s // 128) * 128


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    kv_len: Optional[int] = None, stats: bool = False):
    """Online-softmax attention. q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D),
    Hq a multiple of Hkv; Sq and Skv any lengths. ``kv_len`` masks keys at
    or past it. Returns (B, Hq, Sq, D) in q's dtype; on the card that tensor
    is a view whose ``transpose(1, 2)`` is contiguous, so the model's
    (B, Sq, Hq·D) reshape costs no copy. The kernels read their operands in
    place: on the card, an operand that :func:`operand_error` refuses raises
    ``ValueError`` before any launch.

    ``stats`` (training): returns (out, lse, out_lo) as
    :func:`flash_attention_plain` does. On the card only the wgmma kernel
    stores them (:func:`uses_stats`; anything else raises ``ValueError``),
    in the same launch: ``lse`` is then a view of (B, Hq, :func:`lse_rows`)
    storage and ``out_lo`` is laid out as ``out``. Serving passes no
    ``stats`` and its kernel writes neither."""
    _check(q, k, v)
    b, hq, sq, d = q.shape
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    if not on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=scale,
                                     kv_len=kv_len, stats=stats)
    if stats and not uses_stats(q):
        raise ValueError(f"flash_attention: the forward stores its "
                         f"statistics for bfloat16 at D in {STATS_DIMS} "
                         f"only, got {q.dtype} at D = {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        err = operand_error(t)
        if err is not None:
            raise ValueError(f"flash_attention: {name}: {err}")

    def like_out():
        return torch.empty((b, sq, hq, d), dtype=q.dtype,
                           device=q.device).transpose(1, 2)

    out = like_out()
    kv = -1 if kv_len is None else int(kv_len)
    out_lo = lse = None
    if stats:
        out_lo = like_out()
        lse = torch.empty((b, hq, lse_rows(sq)), dtype=torch.float32,
                          device=q.device)
    if not q.is_meta:  # meta: the dry run's shape rule, no launch
        if stats:
            load_kernels().flash_attention_stats(q, k, v, out, out_lo, lse,
                                                 bool(causal), scale, kv)
        else:
            load_kernels().flash_attention(q, k, v, out, bool(causal),
                                           scale, kv)
        count_launch(flash_attention)
    note_work("flash_attention",
              4 * b * hq * d * _pairs(sq, k.shape[2], causal, kv_len),
              _nbytes(q, k, v, out, out_lo, lse))
    return (out, lse[..., :sq], out_lo) if stats else out


flash_attention.launches = 0


def check_bwd(q: torch.Tensor, k: torch.Tensor, causal: bool,
              kv_len: Optional[int] = None) -> None:
    """Raise ``ValueError`` unless the backward kernel takes the call:
    causal, as many keys as queries, no ``kv_len``."""
    if not causal or kv_len is not None or k.shape[2] != q.shape[2]:
        raise ValueError(
            f"the flash-attention backward takes causal attention with as "
            f"many keys as queries and no kv_len only, got causal={causal}, "
            f"Sq={q.shape[2]}, Skv={k.shape[2]}, kv_len={kv_len}")


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True,
                              sm_scale: Optional[float] = None):
    """Plain version: ``torch.autograd.grad`` of :func:`flash_attention_plain`
    at (q, k, v) against ``dout``. Returns (dq, dk, dv) in the inputs'
    dtype."""
    _check(q, k, v)
    check_bwd(q, k, causal)
    with torch.enable_grad():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = flash_attention_plain(qq, kk, vv, causal=causal,
                                    sm_scale=sm_scale)
        return torch.autograd.grad(out, (qq, kk, vv), dout)


def _check_stats(q: torch.Tensor, lse: Optional[torch.Tensor],
                 out_lo: Optional[torch.Tensor]) -> None:
    """Raise unless ``lse`` and ``out_lo`` (either may be None) are the
    forward's statistics for ``q``: lse float32 (B, Hq, S) and out_lo
    shaped and typed as q, both on q's device."""
    b, hq, s, _ = q.shape
    for name, t, shape, dtype in (("lse", lse, (b, hq, s), torch.float32),
                                  ("out_lo", out_lo, tuple(q.shape),
                                   q.dtype)):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"flash_attention_bwd: {name} has shape "
                             f"{tuple(t.shape)}, want {shape}")
        if t.dtype != dtype:
            raise TypeError(f"flash_attention_bwd: {name} has dtype "
                            f"{t.dtype}, want {dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} is on {t.device},"
                             f" q on {q.device}")


def _stats_rows(lse: torch.Tensor) -> torch.Tensor:
    """``lse`` (B, Hq, S) as the (B, Hq, :func:`lse_rows`) rows the kernels
    read: the storage under it where it is already so laid out (as the
    forward returns it), else a zero-padded copy."""
    b, hq, s = lse.shape
    ld = lse_rows(s)
    if (lse.stride() == (hq * ld, ld, 1) and lse.data_ptr() % 16 == 0
            and lse.untyped_storage().nbytes()
            >= (lse.storage_offset() + b * hq * ld) * 4):
        return lse.as_strided((b, hq, ld), (hq * ld, ld, 1))
    rows = torch.zeros((b, hq, ld), dtype=torch.float32, device=lse.device)
    rows[..., :s] = lse
    return rows


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        lse: Optional[torch.Tensor] = None,
                        out_lo: Optional[torch.Tensor] = None,
                        causal: bool = True,
                        sm_scale: Optional[float] = None):
    """Gradient of :func:`flash_attention` at (q, k, v), whose output was
    ``out``, against ``dout``: (dq, dk, dv), shaped and typed as q, k, v.
    Causal attention with as many keys as queries only; anything else
    raises ``ValueError`` before any launch. ``lse`` and ``out_lo`` are the
    forward's statistics (``flash_attention(..., stats=True)``); they are
    checked wherever given, and on the card bfloat16 at a head dim of
    :data:`STATS_DIMS` needs them (its kernels read the row statistics
    from them instead of rebuilding them). On the card, q, k, v must pass
    :func:`operand_error`; ``out``, ``out_lo`` and ``dout`` that do not are
    copied to a contiguous layout first. On the card the gradients are
    views whose ``transpose(1, 2)`` is contiguous, like the forward's
    output. One call is two kernel launches, counted as one."""
    _check(q, k, v)
    check_bwd(q, k, causal)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError(f"out and dout must have q's dtype {q.dtype}, got "
                        f"{out.dtype}, {dout.dtype}")
    _check_stats(q, lse, out_lo)
    d = q.shape[3]
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    if not on_cuda(q, k, v, out, dout):
        return flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                         sm_scale=scale)
    stats = uses_stats(q)
    if stats and (lse is None or out_lo is None):
        raise ValueError("flash_attention_bwd: bfloat16 at D = "
                         f"{d} runs from the forward's statistics: pass "
                         "lse and out_lo (flash_attention(..., stats=True))")
    for name, t in (("q", q), ("k", k), ("v", v)):
        err = operand_error(t)
        if err is not None:
            raise ValueError(f"flash_attention_bwd: {name}: {err}")
    out, dout = (t if operand_error(t) is None else t.contiguous()
                 for t in (out, dout))

    def grad_like(t):
        bt, ht, st, dt = t.shape
        return torch.empty((bt, st, ht, dt), dtype=t.dtype,
                           device=t.device).transpose(1, 2)

    dq, dk, dv = grad_like(q), grad_like(k), grad_like(v)
    if stats and operand_error(out_lo) is not None:
        out_lo = out_lo.contiguous()
    if not q.is_meta:  # meta: the dry run's shape rule, no launch
        if stats:
            load_kernels().flash_attention_bwd_sm90(
                q, k, v, out, out_lo, dout, _stats_rows(lse), dq, dk, dv,
                scale)
        else:
            load_kernels().flash_attention_bwd(q, k, v, out, dout, dq, dk,
                                               dv, scale)
        count_launch(flash_attention_bwd)
    b, hq, s, d = q.shape
    note_work("flash_attention_bwd",
              10 * b * hq * d * _pairs(s, s, True, None),
              _nbytes(q, k, v, out, dout, dq, dk, dv,
                      *((lse, out_lo) if stats else ())))
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` with :func:`flash_attention_bwd` as its
    gradient. A caller that will need the gradient checks the call with
    :func:`check_bwd` first (``ops.attention`` does), so that a call the
    backward refuses raises before the forward launches, and passes
    ``stats`` where the backward runs from the forward's statistics
    (:func:`uses_stats`): the forward then stores them in its launch and
    saves them for the backward. Serving passes no ``stats``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, stats: bool = False):
        ctx.causal = causal
        if stats:
            out, lse, out_lo = flash_attention(q, k, v, causal=causal,
                                               stats=True)
            ctx.save_for_backward(q, k, v, out, lse, out_lo)
        else:
            out = flash_attention(q, k, v, causal=causal)
            ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, *stats = ctx.saved_tensors
        lse, out_lo = stats if stats else (None, None)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse=lse,
                                         out_lo=out_lo, causal=ctx.causal)
        return dq, dk, dv, None, None
