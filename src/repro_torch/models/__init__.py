"""Port of ``repro/models``: the config-driven decoder stack, for the
attention-only, expert-free architectures, with train, prefill and decode
paths."""
from .config import SHAPES, ModelConfig, ShapeSpec
from .transformer import (decode_step, init_cache, init_params, loss_fn,
                          prefill)

__all__ = ["SHAPES", "ModelConfig", "ShapeSpec", "decode_step", "init_cache",
           "init_params", "loss_fn", "prefill"]
