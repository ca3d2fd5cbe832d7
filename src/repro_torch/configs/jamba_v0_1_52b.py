"""jamba-v0.1-52b — Mamba+attention 1:7 interleave with MoE every other
layer (16 experts top-2) [arXiv:2403.19887].

Per Jamba block of 8 layers: attention at index 4, Mamba elsewhere; MoE MLP
on odd layer indices (16 of 32 layers), dense MLP on the rest."""
from repro_torch.models.config import ModelConfig

_PATTERN = ("m", "m", "m", "m", "a", "m", "m", "m")


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=65536,
        block_pattern=_PATTERN,
        num_experts=16, experts_per_token=2, moe_period=2,
        ssm_state_dim=16, ssm_conv_dim=4, ssm_expand=2,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=512,
        block_pattern=("m", "a", "m", "m"),
        num_experts=4, experts_per_token=2, moe_period=2,
        ssm_state_dim=8, ssm_conv_dim=4, ssm_expand=2,
    )
