"""Port of ``repro/models/layers.py``: ``init_dense`` (:25), ``init_norm``
(:31), ``rms_norm`` (:35), ``rope_cos_sin`` (:46), ``mrope_cos_sin``
(:55), ``apply_rope`` (:77), ``_plain_attention`` (:92),
``flash_attention_xla`` (:108), ``gqa_attention`` (:230) and
``swiglu_mlp`` (:260), in PyTorch on (B, H, S, D) tensors as there.

``gqa_attention`` keeps the reference's dispatch: the einsum attention for
short contexts, the chunked online-softmax attention when ``impl ==
"chunked"`` or ``max(s, t) > 2048``. On the chunked branch the reference
always ran ``flash_attention_xla``, its XLA twin of the Pallas kernel; its
docstrings name the kernel as what replaces the twin on the accelerator, a
switch the reference never built. Here the chunked branch of CUDA tensors
calls :func:`repro_torch.kernels.ops.attention`, the hand-written CUDA
flash-attention kernel, and CPU tensors run the twin
(:func:`flash_attention_xla`, Python loops over the chunks). The two differ
in one rounding only: the twin rounds P to the value dtype before P·V, the
kernel (like the Pallas kernel) does not.

``sharded_decode_attention`` (:167) is the decode attention over a
sequence-sharded KV cache: each rank holds one slice of the cache's
sequence, writes the new position's k/v where it owns it, forms masked
float32 softmax partials over its slice, and combines them with an
all-reduce MAX and two SUMs over the group of the sharded axes, so the
cache is never gathered. The reference runs it as XLA inside a
``shard_map`` (no Pallas kernel); here the partials are plain tensor work on
each rank's slice and the combine names its collectives.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import on_cuda
from ..distributed import collectives as C
from ..kernels import ops
from ..kernels.flash_attention import NEG_INF

__all__ = ["rms_norm", "rope_cos_sin", "apply_rope", "mrope_cos_sin",
           "gqa_attention", "flash_attention_xla", "swiglu_mlp",
           "init_dense", "init_norm", "gen_device",
           "sharded_decode_attention"]


def gen_device(gen: Optional[torch.Generator]) -> torch.device:
    """The device of ``gen``'s draws; ``meta`` for ``gen=None`` (shapes
    and dtypes only, nothing allocated)."""
    return torch.device("meta") if gen is None else gen.device


def init_dense(gen: Optional[torch.Generator], shape,
               scale: Optional[float] = None,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Normal(0, scale²) weights (scale = fan_in^-½ by default, fan_in =
    shape[0]) drawn in float32 from ``gen`` on its device, then cast;
    ``gen=None`` gives a ``device="meta"`` tensor of that shape and
    dtype."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    s = scale if scale is not None else shape[0] ** -0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * s).to(dtype)


def init_norm(shape, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + Qwen2-VL M-RoPE)
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., S) int → cos/sin (..., S, head_dim/2) f32.

    The frequencies θ^(−i/half) are taken in float64 and rounded to
    float32, which gives the correctly rounded values that the reference's
    float32 power gives."""
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freq = (theta ** expo.double()).float()
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions3: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, int, int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE. positions3: (3, B, S) — temporal/height/
    width position ids; each of the head_dim/2 rotary frequencies is driven
    by one of the three streams according to ``sections`` (summing to
    head_dim/2)."""
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    cos, sin = rope_cos_sin(positions3, head_dim, theta)  # (3, B, S, half)
    parts_c, parts_s = [], []
    off = 0
    for axis, sec in enumerate(sections):
        parts_c.append(cos[axis, ..., off:off + sec])
        parts_s.append(sin[axis, ..., off:off + sec])
        off += sec
    return torch.cat(parts_c, -1), torch.cat(parts_s, -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, H, S, D); cos/sin: (B, S, D/2) — rotate-half convention."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    c, s = cos[:, None].float(), sin[:, None].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _plain_attention(q, k, v, causal: bool, kv_valid_len=None):
    """Einsum attention; fine for short sequences. q: (B, Hq, S, D), k/v:
    (B, Hkv, T, D) with Hq a multiple of Hkv (the reference's function for
    Hq = Hkv). Scores in float32; P rounded to v's dtype before P·V.

    The query heads of one kv head are folded into the rows of one product
    with that head's keys, so the kv heads are never repeated."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, hkv, rep * s, d)
    scores = torch.matmul(qg.float(), k.float().transpose(-1, -2)) \
        * (d ** -0.5)
    scores = scores.view(b, hkv, rep, s, t)
    if causal and s > 1:
        mask = (torch.arange(s, device=q.device)[:, None]
                >= torch.arange(t, device=q.device)[None, :] - (t - s))
        scores = torch.where(mask, scores, NEG_INF)
    if kv_valid_len is not None:
        valid = torch.arange(t, device=q.device) < kv_valid_len
        scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype).view(b, hkv, rep * s, t)
    return torch.matmul(p, v).view(b, hq, s, d)


def flash_attention_xla(q, k, v, *, causal: bool, q_chunk: int = 1024,
                        kv_chunk: int = 1024, kv_valid_len=None):
    """Chunked online-softmax attention in plain PyTorch ops, q: (B, H, S,
    D), k/v: (B, H, T, D).

    A loop over q chunks (each sees keys < ``kv_end``, so causal work is
    skipped, not masked) and, inside it, over kv chunks carrying the
    running (m, l, acc); memory O(q_chunk × kv_chunk) instead of O(S²).
    Like the reference, the kv range of a chunk is zero-padded to a
    multiple of ``kv_chunk`` and the padding masked."""
    b, h, s, d = q.shape
    t = k.shape[2]
    scale = d ** -0.5
    outs = []
    for q0 in range(0, s, q_chunk):
        qlen = min(q_chunk, s - q0)
        qc = q[:, :, q0:q0 + qlen]
        kv_end = min(t, (t - s) + q0 + qlen) if causal else t
        nkv = -(-kv_end // kv_chunk)
        pad = (0, 0, 0, nkv * kv_chunk - kv_end)
        kc = F.pad(k[:, :, :kv_end], pad)
        vc = F.pad(v[:, :, :kv_end], pad)
        qpos = (t - s) + q0 + torch.arange(qlen, device=q.device)
        m = torch.full((b, h, qlen), NEG_INF, device=q.device)
        l = torch.zeros((b, h, qlen), device=q.device)
        acc = torch.zeros((b, h, qlen, d), device=q.device)
        for ki in range(nkv):
            kb = kc[:, :, ki * kv_chunk:(ki + 1) * kv_chunk]
            vb = vc[:, :, ki * kv_chunk:(ki + 1) * kv_chunk]
            sc = torch.matmul(qc.float(), kb.float().transpose(-1, -2)) \
                * scale
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=q.device)
            mask = (kpos < kv_end)[None, :]
            if kv_valid_len is not None:
                mask = mask & (kpos < kv_valid_len)[None, :]
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            sc = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.matmul(
                p.to(vb.dtype), vb).float()
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2)


def sharded_decode_attention(q, ck, cv, k_new, v_new, pos: int, *, ctx,
                             seq_axes, rep: int):
    """Decode attention over a KV cache whose sequence is sharded over the
    mesh axes ``seq_axes`` (row-major over them: this rank holds positions
    ``[i·S, (i+1)·S)``, ``i = ctx.index(seq_axes)``), plus the owner's
    write of the new position, without ever gathering the cache.

    q: (B, Hq, 1, hd); ck/cv: (B, Hkv, S, hd), this rank's slice (written in
    place); k_new/v_new: (B, Hkv, 1, hd); ``pos``: the new position (an
    int); ``ctx``: the :class:`~repro_torch.distributed.meshctx.
    MeshContext` whose groups combine the partials; ``rep`` = Hq / Hkv.
    Each rank forms float32 partials over the positions ``≤ pos`` of its
    slice (row max m, Σ exp(s − m), Σ exp(s − m)·v), then m is all-reduced
    with MAX and the corrected sums with SUM over the group: the wire
    carries O(B·Hq·hd). Returns (out (B, Hq, 1, hd) in q's dtype, ck,
    cv)."""
    b, hkv, s_loc, hd = ck.shape
    group = ctx.group(seq_axes)
    start = ctx.index(seq_axes) * s_loc
    lpos = pos - start
    if 0 <= lpos < s_loc:  # the owner writes the new position
        ck[:, :, lpos] = k_new[:, :, 0].to(ck.dtype)
        cv[:, :, lpos] = v_new[:, :, 0].to(cv.dtype)
    # the positions of this slice that are ≤ pos (the rest are masked in the
    # reference; here they are not read)
    n = min(max(pos - start + 1, 0), s_loc)
    qg = q.reshape(b, hkv, rep, hd).to(torch.float32)
    kk = ck[:, :, :n].to(torch.float32)
    vv = cv[:, :, :n].to(torch.float32)
    scores = torch.einsum("bhrd,bhsd->bhrs", qg, kk) * hd ** -0.5
    if n:
        m = scores.amax(dim=-1)                           # (b, hkv, rep)
    else:
        m = torch.full((b, hkv, rep), NEG_INF, dtype=torch.float32,
                       device=q.device)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhrs,bhsd->bhrd", p, vv)
    m_g = C.all_reduce(m.clone(), group, "max")
    corr = torch.exp(m - m_g)
    l_g = C.all_reduce(l * corr, group)
    o_g = C.all_reduce(o * corr[..., None], group)
    out = o_g / l_g.clamp(min=1e-30)[..., None]
    return out.reshape(b, hkv * rep, 1, hd).to(q.dtype), ck, cv


def gqa_attention(q, k, v, *, causal: bool, q_chunk: int, kv_chunk: int,
                  kv_valid_len=None, impl: str = "auto"):
    """Grouped-query attention dispatcher. q: (B, Hq, S, D), k/v: (B, Hkv,
    T, D).

    ``impl``: ``"plain"`` (einsum), ``"chunked"``, or ``"auto"`` (chunked
    when ``max(s, t) > 2048``). On CUDA tensors the chunked branch runs the
    flash-attention kernel through :func:`repro_torch.kernels.ops.attention`
    (causal only for ``t == s``, without ``kv_valid_len``: the model never
    asks for more there). On CPU tensors the chunked branch is the plain
    twin, with the kv heads broadcast to the query head groups without
    materializing the repeat, as in the reference."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    use_chunked = (impl == "chunked") or (impl == "auto" and max(s, t) > 2048)
    if not use_chunked:
        return _plain_attention(q, k, v, causal, kv_valid_len)
    if on_cuda(q, k, v):
        if kv_valid_len is not None or (causal and t != s):
            raise NotImplementedError(
                "the flash-attention kernel takes causal attention with "
                "t == s and no kv_valid_len only")
        return ops.attention(q, k, v, causal=causal)
    rep = hq // hkv
    qg = q.reshape(b * hkv, rep, s, d)
    kg = k.reshape(b * hkv, 1, t, d).expand(b * hkv, rep, t, d)
    vg = v.reshape(b * hkv, 1, t, d).expand(b * hkv, rep, t, d)
    out = flash_attention_xla(qg, kg, vg, causal=causal, q_chunk=q_chunk,
                              kv_chunk=kv_chunk, kv_valid_len=kv_valid_len)
    return out.reshape(b, hq, s, d)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu_mlp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
               wd: torch.Tensor) -> torch.Tensor:
    g = x @ wg
    u = x @ wu
    return (F.silu(g.float()).to(x.dtype) * u) @ wd
