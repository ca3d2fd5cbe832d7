"""Port of ``repro/models/config.py``: :class:`ModelConfig`,
:class:`ShapeSpec` and :data:`SHAPES`, copied.

One frozen dataclass covers all 10 assigned architectures and drives
parameter shapes, layer pattern, and the prefill/decode paths in
:mod:`repro_torch.models.transformer`.

``block_pattern`` gives the per-layer *mixer* kind:
  'a' — GQA attention,  'm' — Mamba SSM,  'M' — mLSTM,  's' — sLSTM.
``moe_period > 0`` makes every ``moe_period``-th layer's MLP a top-k MoE.
The port builds, serves and trains every kind. ``moe_impl`` picks the
MoE layer's branch over a training mesh; ``capacity_factor`` is read by
its ``ep`` branch, while the path without a mesh and ``tp_ragged`` keep the
reference's fixed factor of 1.25. Of the execution knobs, ``remat`` is
read by the training forward (a checkpoint a layer); ``scan_layers`` is
kept for the copy and read by nothing in the port, which loops over its
layers either way.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 → d_model // num_heads

    # mixer pattern ('a'/'m'/'M'/'s'), must tile num_layers
    block_pattern: Tuple[str, ...] = ("a",)

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 0            # layer i uses MoE MLP iff (i % moe_period == moe_period-1)
    capacity_factor: float = 1.25
    moe_impl: str = "tp_ragged"    # tp_ragged (dropless, expert-TP) | ep (all-to-all)

    # MLP variant: gated SwiGLU (llama-family) vs plain GELU (starcoder2,
    # musicgen)
    mlp_gated: bool = True

    # attention details
    qk_norm: bool = False
    rope_theta: float = 1e4
    mrope: bool = False            # Qwen2-VL M-RoPE (3-section rope)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    # SSM (Mamba) details
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0           # 0 → ceil(d_model / 16)

    # xLSTM details
    xlstm_proj_factor: float = 2.0

    # frontend / IO
    input_mode: str = "tokens"     # tokens | embeddings (VLM/audio stubs)
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # execution knobs (overridable by the autotuner / perf experiments)
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    remat: str = "layer"           # none | layer (checkpoint each block group)
    scan_layers: bool = True

    def __post_init__(self):
        assert self.num_layers % len(self.block_pattern) == 0, (
            self.name, "block_pattern must tile num_layers")
        assert self.num_heads % self.num_kv_heads == 0

    # -- derived -------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def pattern_period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_groups(self) -> int:
        return self.num_layers // self.pattern_period

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    def layer_kind(self, i: int) -> str:
        return self.block_pattern[i % self.pattern_period]

    def layer_is_moe(self, i: int) -> bool:
        if self.num_experts == 0 or self.layer_kind(i) in ("M", "s"):
            return False
        p = self.moe_period or 1
        return (i % p) == (p - 1)

    @property
    def attn_layers(self) -> Tuple[int, ...]:
        return tuple(i for i in range(self.num_layers)
                     if self.layer_kind(i) == "a")

    @property
    def ssm_layers(self) -> Tuple[int, ...]:
        return tuple(i for i in range(self.num_layers)
                     if self.layer_kind(i) == "m")

    @property
    def sub_quadratic(self) -> bool:
        """True when decode state does not grow quadratically with context —
        i.e. the arch may run the long_500k shape (SSM / hybrid / linear)."""
        return any(k in ("m", "M", "s") for k in self.block_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + per-layer + head)."""
        d, hd = self.d_model, self.head_dim_
        total = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += d * self.vocab_size
        total += d  # final norm
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            total += d  # pre-mixer norm
            if kind == "a":
                total += d * (self.num_heads * hd) * 2  # wq, wo
                total += d * (self.num_kv_heads * hd) * 2  # wk, wv
                if self.qk_norm:
                    total += 2 * hd
            elif kind == "m":
                di, N, r = self.d_inner, self.ssm_state_dim, self.dt_rank
                total += d * 2 * di + self.ssm_conv_dim * di
                total += di * (r + 2 * N) + r * di + di * N + di + di * d
            elif kind in ("M", "s"):
                di = int(self.xlstm_proj_factor * d)
                total += d * 2 * di + 4 * di * di // 1 + di * d  # approx
            if kind in ("a", "m"):
                total += d  # pre-MLP norm
                n_in = 2 if self.mlp_gated else 1
                if self.layer_is_moe(i):
                    e = self.num_experts
                    total += d * e  # router
                    total += e * (n_in * d * self.d_ff + self.d_ff * d)
                elif self.d_ff:
                    total += n_in * d * self.d_ff + self.d_ff * d
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only) — the N in
        MODEL_FLOPS = 6·N_active·D."""
        if self.num_experts == 0:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        n_in = 2 if self.mlp_gated else 1
        for i in range(self.num_layers):
            if self.layer_is_moe(i):
                e, k = self.num_experts, self.experts_per_token
                expert_params = n_in * d * self.d_ff + self.d_ff * d
                total -= (e - k) * expert_params
        return total


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
