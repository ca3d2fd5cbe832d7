"""Port of ``ExecutionPlan`` (:34) from ``repro/distributed/sharding.py``,
with its ``apply`` (:64): the execution-strategy knobs of one (arch × shape
× mesh) cell, which the trainer and the training launcher take.

Only the knobs that one device reads are here: ``remat`` and the attention
chunk sizes, which ``apply`` copies into the model config. The reference's
spec functions (``param_specs``, ``opt_state_spec_for``, ``batch_specs``,
``cache_specs``, ``to_shardings``), which lay parameters, ZeRO optimizer
state, batches and caches over a mesh, wait for the mesh slice (ROADMAP §1,
item 3.1b), and so do the knobs that only a mesh reads (``fsdp_params``,
``grad_compression``, ``pure_dp``, ``attn_batch_reshard``,
``shard_activation_ckpt``, ``seq_shard_decode``) and those of layers the
port does not build (``moe_impl``) or of a scan it does not run
(``scan_layers``): they come with the code that reads them.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig

__all__ = ["ExecutionPlan"]


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Execution-strategy choices for one (arch × shape) cell on one device."""
    remat: str = "layer"            # none | layer
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024

    def apply(self, cfg: ModelConfig) -> ModelConfig:
        return dataclasses.replace(
            cfg, remat=self.remat, attn_q_chunk=self.attn_q_chunk,
            attn_kv_chunk=self.attn_kv_chunk)
