"""Port of ``repro/kernels/flash_attention.py`` (``flash_attention``,
``pallas_call`` at :91) as a hand-written CUDA kernel
(``csrc/flash_attention.cu``), with its plain PyTorch version beside it: the
reference's oracle ``repro/kernels/ref.py::attention_ref`` (:11-28).

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
``flash_attention.launches``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import on_cuda
from ._build import load_kernels

__all__ = ["flash_attention", "flash_attention_plain", "NEG_INF"]

NEG_INF = -1e30


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


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          sm_scale: Optional[float] = None,
                          kv_len: Optional[int] = None) -> torch.Tensor:
    """Plain version: ``attention_ref`` over the grouped heads, the whole
    (Sq, Skv) score matrix in float32 at once."""
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
    p = torch.softmax(s, dim=-1).view(b, hkv, hq // hkv * sq, skv)
    out = torch.matmul(p, v.float())
    return out.view(b, hq, sq, d).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: Optional[float] = None,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention. q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D),
    Hq a multiple of Hkv; Sq and Skv any lengths. ``kv_len`` masks keys at
    or past it. Returns (B, Hq, Sq, D) in q's dtype; on the card that tensor
    is a view whose ``transpose(1, 2)`` is contiguous, so the model's
    (B, Sq, Hq·D) reshape costs no copy. The kernel reads its operands in
    place: each needs a unit stride along D and batch, head and sequence
    strides that are multiples of 8 elements (any contiguous tensor, or the
    model's head-transposed views), or the launch raises."""
    _check(q, k, v)
    b, hq, sq, d = q.shape
    scale = d ** -0.5 if sm_scale is None else float(sm_scale)
    if not on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=scale,
                                     kv_len=kv_len)
    out = torch.empty((b, sq, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    load_kernels().flash_attention(q, k, v, out, bool(causal), scale,
                                   -1 if kv_len is None else int(kv_len))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
