"""xlstm-125m — sLSTM + mLSTM blocks, ratio ~7:1 mLSTM:sLSTM
[arXiv:2405.04517]. d_ff=0: xLSTM blocks carry their own projections."""
from repro_torch.models.config import ModelConfig

# 12 layers, sLSTM at positions 5 and 11 (period-6 pattern, 2/12 sLSTM).
_PATTERN = ("M", "M", "M", "M", "M", "s")


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304,
        block_pattern=_PATTERN, xlstm_proj_factor=2.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="xlstm-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
        d_ff=0, vocab_size=512,
        block_pattern=("M", "s"), xlstm_proj_factor=2.0,
    )
