"""llama3.2-1b — small llama3 (GQA kv=8, theta=5e5, tied embeddings)
[hf:meta-llama/Llama-3.2-1B]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", family="dense",
        num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
        d_ff=8192, vocab_size=128256,
        rope_theta=5e5, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama32-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, tie_embeddings=True,
    )
