"""Port of ``repro/models/ssm.py``: the Mamba selective-SSM mixer (Jamba's
'm' layers): ``init_mamba_params`` (:27), ``_causal_conv`` (:48),
``_ssm_chunk`` (:59), ``mamba_forward`` (:79), ``init_mamba_state``
(:129) and ``mamba_decode_step`` (:136).

The prefill runs the chunkwise scan: within a chunk of ``chunk`` steps the
recurrence h_t = Ābar_t·h_{t-1} + B̄x_t is a scan of (log Ābar, B̄x) pairs
under the reference's combine, ((l₁, s₁), (l₂, s₂)) → (l₁ + l₂,
s₁·exp(l₂) + s₂); chunks are chained through the (B, d_inner, N) float32
state. PyTorch has no ``associative_scan``, so the chunk's scan is a
log-step (Hillis–Steele) scan over the chunk axis: ⌈log₂ chunk⌉ rounds,
each combining every position with the one 2^r before it. It applies the
same combine in another tree than JAX's, so the two differ by float32
rounding only, and it holds (B, chunk, d_inner, N) at a time, never a
(B, chunk, chunk, d_inner, N) tensor. Time is padded to a chunk multiple
with dt = 0, an identity step (Ābar = 1, B̄x = 0), so the state at the
last real position is exact.

Decode is the O(1) recurrence on a rolling conv window.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import gen_device, init_dense

__all__ = ["init_mamba_params", "mamba_forward", "mamba_decode_step",
           "init_mamba_state"]


def init_mamba_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                      dtype) -> Dict[str, torch.Tensor]:
    """The reference's leaves: projections N(0, 1/fan_in) in ``dtype``
    (``dt_proj`` at dt_rank^-½), the conv N(0, 0.2²), and ``dt_bias``,
    ``a_log`` (log 1 … log N on every channel) and ``d_skip`` in float32."""
    d, di, n, r, dc = (cfg.d_model, cfg.d_inner, cfg.ssm_state_dim,
                       cfg.dt_rank, cfg.ssm_conv_dim)
    dev = gen_device(gen)
    f32 = torch.float32
    return dict(
        in_proj=init_dense(gen, (d, 2 * di), dtype=dtype),
        conv_w=init_dense(gen, (dc, di), scale=0.2, dtype=dtype),
        conv_b=torch.zeros((di,), dtype=dtype, device=dev),
        x_proj=init_dense(gen, (di, r + 2 * n), dtype=dtype),
        dt_proj=init_dense(gen, (r, di), scale=r ** -0.5, dtype=dtype),
        dt_bias=torch.log(torch.expm1(torch.full((di,), 0.01, dtype=f32,
                                                 device=dev))),
        a_log=torch.log(torch.arange(1, n + 1, dtype=f32, device=dev)
                        ).expand(di, n).contiguous(),
        d_skip=torch.ones((di,), dtype=f32, device=dev),
        out_proj=init_dense(gen, (di, d), dtype=dtype),
    )


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, summed in float32 tap by tap. x:
    (B, S, di); w: (dc, di)."""
    dc, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, dc - 1, 0))
    out = pad[:, :s].float() * w[0].float()
    for j in range(1, dc):
        out = out + pad[:, j:j + s].float() * w[j].float()
    return (out + b.float()).to(x.dtype)


def _scan(logs: torch.Tensor, acc: torch.Tensor):
    """Inclusive scan over axis 1 of (log Ābar, B̄x) pairs under the
    selective scan's combine, in ⌈log₂ c⌉ rounds."""
    c, d = logs.shape[1], 1
    while d < c:
        acc = torch.cat([acc[:, :d],
                         acc[:, :-d] * torch.exp(logs[:, d:]) + acc[:, d:]],
                        dim=1)
        logs = torch.cat([logs[:, :d], logs[:, :-d] + logs[:, d:]], dim=1)
        d *= 2
    return logs, acc


def _ssm_chunk(h0, dt, b_in, c_in, xc, a):
    """One chunk of the selective scan. h0: (B, di, N) carry; dt: (B, c,
    di); b_in/c_in: (B, c, N); xc: (B, c, di); a: (di, N). Returns (y (B,
    c, di), h_end)."""
    log_abar = dt[..., None] * a                               # ≤ 0
    bx = (dt * xc)[..., None] * b_in[:, :, None, :]
    logs, acc = _scan(log_abar, bx)
    h = acc + torch.exp(logs) * h0[:, None]                    # (B,c,di,N)
    y = torch.einsum("bcdn,bcn->bcd", h, c_in)
    return y, h[:, -1]


def _dt(params, dt_r: torch.Tensor) -> torch.Tensor:
    return F.softplus(dt_r @ params["dt_proj"].float() + params["dt_bias"])


def mamba_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                  cfg: ModelConfig, chunk: int = 256,
                  return_state: bool = False):
    """x: (B, S, D) → (B, S, D) [, the decode state at the last position]."""
    b, s, _ = x.shape
    n, r = cfg.ssm_state_dim, cfg.dt_rank
    x_in, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    xc = F.silu(_causal_conv(x_in, params["conv_w"], params["conv_b"]
                             ).float()).to(x.dtype)
    proj = (xc @ params["x_proj"]).float()
    dt_r, b_in, c_in = proj.split([r, n, n], dim=-1)
    dt = _dt(params, dt_r)                                     # (B,S,di) f32
    a = -torch.exp(params["a_log"])
    c = min(chunk, s)
    pad = (-s) % c
    xcp = xc
    if pad:
        dt, b_in, c_in, xcp = (F.pad(t, (0, 0, 0, pad))
                               for t in (dt, b_in, c_in, xc))
    h = torch.zeros((b, cfg.d_inner, n), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t0 in range(0, s + pad, c):
        sl = slice(t0, t0 + c)
        y, h = _ssm_chunk(h, dt[:, sl], b_in[:, sl], c_in[:, sl],
                          xcp[:, sl].float(), a)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s] + xc.float() * params["d_skip"]
    out = y.to(x.dtype) * F.silu(z.float()).to(x.dtype)
    out = out @ params["out_proj"]
    if return_state:
        dc = cfg.ssm_conv_dim
        win = F.pad(x_in, (0, 0, max(dc - 1 - s, 0), 0))[:, -(dc - 1):]
        return out, dict(conv=win.contiguous(), ssm=h)
    return out


def init_mamba_state(cfg: ModelConfig, batch: int, dtype,
                     device) -> Dict[str, torch.Tensor]:
    return dict(
        conv=torch.zeros((batch, cfg.ssm_conv_dim - 1, cfg.d_inner),
                         dtype=dtype, device=device),
        ssm=torch.zeros((batch, cfg.d_inner, cfg.ssm_state_dim),
                        dtype=torch.float32, device=device))


def mamba_decode_step(params, state, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, 1, D) → (y (B, 1, D), the new state). O(1) in the context."""
    n, r = cfg.ssm_state_dim, cfg.dt_rank
    x_in, z = (x @ params["in_proj"]).chunk(2, dim=-1)        # (B,1,di)
    window = torch.cat([state["conv"], x_in], dim=1)          # (B,dc,di)
    conv = (window.float() * params["conv_w"][None].float()).sum(dim=1) \
        + params["conv_b"].float()
    xc = F.silu(conv).to(x.dtype)                              # (B,di)
    proj = (xc @ params["x_proj"]).float()
    dt_r, b_in, c_in = proj.split([r, n, n], dim=-1)
    dt = _dt(params, dt_r)                                     # (B,di)
    abar = torch.exp(dt[..., None] * -torch.exp(params["a_log"]))
    h = state["ssm"] * abar + (dt * xc.float())[..., None] * b_in[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c_in) + xc.float() * params["d_skip"]
    out = y.to(x.dtype) * F.silu(z[:, 0].float()).to(x.dtype)
    return (out @ params["out_proj"])[:, None], dict(conv=window[:, 1:],
                                                     ssm=h)
