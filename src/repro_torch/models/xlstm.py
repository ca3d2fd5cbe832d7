"""Port of ``repro/models/xlstm.py``: the xLSTM mixers of xlstm-125m. The
mLSTM ('M' layers): ``_xl_dims`` (:35), ``init_mlstm_params`` (:42),
``_mlstm_qkvif`` (:60), ``mlstm_forward`` (:79), ``init_mlstm_state``
(:147) and ``mlstm_decode_step`` (:154); the sLSTM ('s' layers):
``init_slstm_params`` (:189), ``_slstm_cell`` (:203), ``slstm_forward``
(:225), ``init_slstm_state`` (:249) and ``slstm_decode_step`` (:255).

The mLSTM is the stabilized sigmoid-gated variant, computed chunkwise as
there: an intra-chunk decay matrix D_ij = exp(F_i − F_j)·i_j (F the
cumulative log forget gate) and an inter-chunk (C, n) float32 state
chained over the chunks; decode is the O(1) recurrence on a float32 conv
window. The sLSTM has exponential gating with the m stabilizer (started at
−1e30) and a diagonal recurrence, a Python loop over time where the
reference has ``lax.scan``. As there: the per-head group norm takes the
population variance, and the sLSTM's post-up MLP the tanh-approximate
GELU (``jax.nn.gelu``'s default).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import gen_device, init_dense, rms_norm
from .ssm import _causal_conv

__all__ = ["init_mlstm_params", "mlstm_forward", "mlstm_decode_step",
           "init_mlstm_state", "init_slstm_params", "slstm_forward",
           "slstm_decode_step", "init_slstm_state"]

#: the mLSTM's conv width, fixed in the reference
MLSTM_CONV = 4


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _xl_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    di = int(cfg.xlstm_proj_factor * cfg.d_model)
    h = cfg.num_heads
    di -= di % h
    return di, h, di // h


def init_mlstm_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                      dtype) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    di, h, _ = _xl_dims(cfg)
    dev, f32 = gen_device(gen), torch.float32
    return dict(
        up_proj=init_dense(gen, (d, 2 * di), dtype=dtype),
        conv_w=init_dense(gen, (MLSTM_CONV, di), scale=0.2, dtype=dtype),
        q_proj=init_dense(gen, (di, di), dtype=dtype),
        k_proj=init_dense(gen, (di, di), dtype=dtype),
        v_proj=init_dense(gen, (di, di), dtype=dtype),
        i_gate=init_dense(gen, (di, h), dtype=f32),
        f_gate=init_dense(gen, (di, h), dtype=f32),
        f_bias=torch.full((h,), 3.0, dtype=f32, device=dev),
        gn_scale=torch.ones((di,), dtype=dtype, device=dev),
        out_proj=init_dense(gen, (di, d), dtype=dtype),
    )


def _mlstm_qkvif(params, x: torch.Tensor, cfg: ModelConfig):
    di, h, dh = _xl_dims(cfg)
    b, s, _ = x.shape
    xm, z = (x @ params["up_proj"]).chunk(2, dim=-1)
    xc = F.silu(_causal_conv(xm, params["conv_w"], torch.zeros(
        (di,), dtype=x.dtype, device=x.device)).float()).to(x.dtype)
    q = (xc @ params["q_proj"]).view(b, s, h, dh)
    k = (xc @ params["k_proj"]).view(b, s, h, dh) * (dh ** -0.5)
    v = (xm @ params["v_proj"]).view(b, s, h, dh)
    xcf = xc.float()
    i = torch.sigmoid(xcf @ params["i_gate"])                  # (B,S,H)
    logf = F.logsigmoid(xcf @ params["f_gate"] + params["f_bias"])
    return xm, q, k, v, i, logf, z


def _group_norm(out: torch.Tensor) -> torch.Tensor:
    """Per-head normalisation over the head dim (population variance)."""
    mean = out.mean(dim=-1, keepdim=True)
    var = out.var(dim=-1, keepdim=True, unbiased=False)
    return (out - mean) * torch.rsqrt(var + 1e-5)


def _mlstm_chunk(C, n, qc, kc, vc, ic, lfc, causal):
    """One chunk: (C, n) at its start → (its outputs (B, c, H, dh), C, n
    at its end)."""
    qf, kf, vf = qc.float(), kc.float(), vc.float()
    Fc = torch.cumsum(lfc, dim=1)                              # (B,c,H)
    dmat = torch.where(causal[None, :, :, None],
                       torch.exp(Fc[:, :, None, :] - Fc[:, None, :, :]),
                       0.0)                                    # (B,c,c,H)
    att = torch.einsum("bihe,bjhe->bijh", qf, kf) * dmat * ic[:, None]
    h_intra = torch.einsum("bijh,bjhe->bihe", att, vf)
    nk = torch.einsum("bijh,bjhe->bihe", dmat * ic[:, None], kf)
    qe = qf * torch.exp(Fc)[..., None]
    num = h_intra + torch.einsum("bihe,bhef->bihf", qe, C)
    den_q = torch.einsum("bihe,bihe->bih", qf, nk) + torch.einsum(
        "bihe,bhe->bih", qe, n)
    out = num / torch.clamp(den_q.abs(), min=1.0)[..., None]
    f_end = torch.exp(Fc[:, -1])                               # (B,H)
    decay_j = torch.exp(Fc[:, -1][:, None] - Fc) * ic          # (B,c,H)
    C = C * f_end[..., None, None] + torch.einsum(
        "bjh,bjhe,bjhf->bhef", decay_j, kf, vf)
    n = n * f_end[..., None] + torch.einsum("bjh,bjhe->bhe", decay_j, kf)
    return out, C, n


def mlstm_forward(params, x: torch.Tensor, cfg: ModelConfig,
                  chunk: int = 256, return_state: bool = False):
    """x: (B, S, D) → (B, S, D) [, the decode state at the last position]."""
    b, s, _ = x.shape
    di, h, dh = _xl_dims(cfg)
    xm, q, k, v, i, logf, z = _mlstm_qkvif(params, x, cfg)
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        i, logf = (F.pad(t, (0, 0, 0, pad)) for t in (i, logf))
    causal = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    C = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
    n = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
    outs = []
    for t0 in range(0, s + pad, c):
        sl = slice(t0, t0 + c)
        out, C, n = _mlstm_chunk(C, n, q[:, sl], k[:, sl], v[:, sl],
                                 i[:, sl], logf[:, sl], causal)
        outs.append(out)
    out = _group_norm(torch.cat(outs, dim=1)[:, :s])
    out = out.reshape(b, s, di).to(x.dtype) * params["gn_scale"]
    out = out * F.silu(z.float()).to(x.dtype)
    y = out @ params["out_proj"]
    if return_state:
        w = MLSTM_CONV - 1
        win = F.pad(xm.float(), (0, 0, max(w - s, 0), 0))[:, -w:]
        return y, dict(C=C, n=n, conv=win.contiguous())
    return y


def init_mlstm_state(cfg: ModelConfig, batch: int,
                     device) -> Dict[str, torch.Tensor]:
    di, h, dh = _xl_dims(cfg)
    f32 = torch.float32
    return dict(C=torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
                n=torch.zeros((batch, h, dh), dtype=f32, device=device),
                conv=torch.zeros((batch, MLSTM_CONV - 1, di), dtype=f32,
                                 device=device))


def mlstm_decode_step(params, state, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, 1, D); the O(1) recurrent update."""
    b = x.shape[0]
    di, h, dh = _xl_dims(cfg)
    xm, z = (x @ params["up_proj"]).chunk(2, dim=-1)          # (B,1,di)
    window = torch.cat([state["conv"], xm.float()], dim=1)
    conv = (window * params["conv_w"][None].float()).sum(dim=1)
    xc = F.silu(conv).to(x.dtype)                              # (B,di)
    q = (xc @ params["q_proj"]).view(b, h, dh).float()
    k = ((xc @ params["k_proj"]).view(b, h, dh) * (dh ** -0.5)).float()
    v = (xm[:, 0] @ params["v_proj"]).view(b, h, dh).float()
    xcf = xc.float()
    i = torch.sigmoid(xcf @ params["i_gate"])                  # (B,H)
    f = torch.sigmoid(xcf @ params["f_gate"] + params["f_bias"])
    C = state["C"] * f[..., None, None] + i[..., None, None] * (
        k[..., :, None] * v[..., None, :])                     # (B,H,dh,dh)
    n = state["n"] * f[..., None] + i[..., None] * k
    num = torch.einsum("bhe,bhef->bhf", q, C)
    den = torch.clamp(torch.einsum("bhe,bhe->bh", q, n).abs(), min=1.0)
    out = _group_norm(num / den[..., None]).reshape(b, di)
    out = out.to(x.dtype) * params["gn_scale"]
    out = out * F.silu(z[:, 0].float()).to(x.dtype)
    return (out @ params["out_proj"])[:, None], dict(C=C, n=n,
                                                     conv=window[:, 1:])


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                      dtype) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    dup = int(4 * d / 3 / 2) * 2  # post-up MLP width (pf 4/3)
    dev, f32 = gen_device(gen), torch.float32
    return dict(
        w_izfo=init_dense(gen, (d, 4 * d), dtype=dtype),
        r_izfo=init_dense(gen, (4, d), scale=0.1, dtype=f32),
        b_izfo=torch.zeros((4, d), dtype=f32, device=dev),
        up_w=init_dense(gen, (d, 2 * dup), dtype=dtype),
        down_w=init_dense(gen, (dup, d), dtype=dtype),
        norm2=torch.ones((d,), dtype=dtype, device=dev),
    )


def _slstm_cell(params, xw: torch.Tensor, state):
    """One time step. xw: (B, 4, d) pre-activations from the input
    projection; state (c, n, h, m)."""
    c, n, hprev, m = state
    r, b = params["r_izfo"], params["b_izfo"]
    zi = xw[:, 0] + r[0] * hprev + b[0]
    zz = xw[:, 1] + r[1] * hprev + b[1]
    zf = xw[:, 2] + r[2] * hprev + b[2]
    zo = xw[:, 3] + r[3] * hprev + b[3]
    log_f = F.logsigmoid(zf)
    m_new = torch.maximum(log_f + m, zi)
    i = torch.exp(zi - m_new)
    f = torch.exp(log_f + m - m_new)
    c_new = f * c + i * torch.tanh(zz)
    n_new = f * n + i
    h = torch.sigmoid(zo) * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, h, m_new), h


def _slstm_mlp(params, h: torch.Tensor, dtype) -> torch.Tensor:
    """The post-up gated MLP on the cell outputs (B, S, d) in ``dtype``."""
    h = rms_norm(h, params["norm2"], 1e-5)
    u, g = (h @ params["up_w"]).chunk(2, dim=-1)
    return (u * F.gelu(g.float(), approximate="tanh").to(dtype)) \
        @ params["down_w"]


def slstm_forward(params, x: torch.Tensor, cfg: ModelConfig,
                  return_state: bool = False):
    b, s, d = x.shape
    xw = (x @ params["w_izfo"]).float().view(b, s, 4, d)
    state = init_slstm_state(cfg, b, x.device)
    state = (state["c"], state["n"], state["h"], state["m"])
    hs = []
    for t in range(s):
        state, h = _slstm_cell(params, xw[:, t], state)
        hs.append(h)
    y = _slstm_mlp(params, torch.stack(hs, dim=1).to(x.dtype), x.dtype)
    if return_state:
        return y, dict(zip(("c", "n", "h", "m"), state))
    return y


def init_slstm_state(cfg: ModelConfig, batch: int,
                     device) -> Dict[str, torch.Tensor]:
    shape, f32 = (batch, cfg.d_model), torch.float32
    return dict(c=torch.zeros(shape, dtype=f32, device=device),
                n=torch.zeros(shape, dtype=f32, device=device),
                h=torch.zeros(shape, dtype=f32, device=device),
                m=torch.full(shape, -1e30, dtype=f32, device=device))


def slstm_decode_step(params, state, x: torch.Tensor, cfg: ModelConfig):
    b, d = x.shape[0], cfg.d_model
    xw = (x[:, 0] @ params["w_izfo"]).float().view(b, 4, d)
    (c, n, h, m), hout = _slstm_cell(
        params, xw, (state["c"], state["n"], state["h"], state["m"]))
    y = _slstm_mlp(params, hout[:, None].to(x.dtype), x.dtype)
    return y, dict(c=c, n=n, h=h, m=m)
