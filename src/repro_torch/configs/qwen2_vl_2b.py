"""qwen2-vl-2b — M-RoPE + dynamic resolution [arXiv:2409.12191].

The vision frontend is a STUB per the assignment: ``input_specs`` supplies
precomputed patch embeddings (B, S, d_model) plus the (3, B, S) M-RoPE
position ids the ViT+merger would produce."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm",
        num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
        head_dim=128, d_ff=8960, vocab_size=151936,
        mrope=True, mrope_sections=(16, 24, 24), rope_theta=1e6,
        input_mode="embeddings",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2vl-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        mrope=True, mrope_sections=(2, 3, 3), input_mode="embeddings",
    )
