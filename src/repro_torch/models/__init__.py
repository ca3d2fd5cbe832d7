"""Port of ``repro/models``: the config-driven decoder stack, for the
attention-only, expert-free architectures, with prefill and decode paths.
The reference's exports less ``loss_fn``, which waits for training."""
from .config import SHAPES, ModelConfig, ShapeSpec
from .transformer import decode_step, init_cache, init_params, prefill

__all__ = ["SHAPES", "ModelConfig", "ShapeSpec", "decode_step", "init_cache",
           "init_params", "prefill"]
