"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec frontend is a STUB: ``input_specs`` supplies precomputed frame
embeddings (the sum of the 4 codebook embeddings); the backbone predicts the
next frame's codes over the 2048-entry codebook vocabulary."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=2048, mlp_gated=False,
        input_mode="embeddings",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=128, mlp_gated=False, input_mode="embeddings",
    )
