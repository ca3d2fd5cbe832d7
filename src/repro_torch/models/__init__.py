"""Port of ``repro/models``: the config-driven decoder stack, with prefill
and decode paths for every architecture (attention, Mamba, mLSTM and sLSTM
mixers, dense and MoE MLPs) and the training path for the attention-only,
expert-free ones."""
from .config import SHAPES, ModelConfig, ShapeSpec
from .transformer import (decode_step, init_cache, init_params, loss_fn,
                          prefill)

__all__ = ["SHAPES", "ModelConfig", "ShapeSpec", "decode_step", "init_cache",
           "init_params", "loss_fn", "prefill"]
