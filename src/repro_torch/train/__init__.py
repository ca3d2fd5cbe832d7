"""Port of ``repro/train``: optimizer (AdamW with float32 master weights),
schedule, checkpointing, synthetic data pipeline, fault-tolerant trainer,
on one device."""
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .data import SyntheticData, input_specs
from .optimizer import AdamWConfig, adamw_update, init_opt_state
from .schedule import warmup_cosine
from .trainer import Trainer, TrainerConfig

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint",
           "SyntheticData", "input_specs", "AdamWConfig", "adamw_update",
           "init_opt_state", "warmup_cosine", "Trainer", "TrainerConfig"]
