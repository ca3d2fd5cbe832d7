"""codeqwen1.5-7b — qwen1.5 architecture (MHA) [hf:Qwen/CodeQwen1.5-7B]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b", family="dense",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
        d_ff=13440, vocab_size=92416, rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="codeqwen-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, rope_theta=1e6,
    )
