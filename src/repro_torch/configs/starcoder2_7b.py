"""starcoder2-7b — GQA (kv=4) + RoPE [arXiv:2402.19173]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b", family="dense",
        num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
        d_ff=18432, vocab_size=49152, mlp_gated=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke", family="dense",
        num_layers=2, d_model=72, num_heads=6, num_kv_heads=2,
        d_ff=160, vocab_size=512, mlp_gated=False,
    )
