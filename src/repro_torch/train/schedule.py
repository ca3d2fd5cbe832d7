"""Port of ``repro/train/schedule.py``: ``warmup_cosine`` (:9), linear
warmup and cosine decay to a floor."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine"]


def warmup_cosine(step, *, warmup_steps: int = 100, total_steps: int = 10000,
                  floor: float = 0.1) -> torch.Tensor:
    """The learning-rate scale at ``step`` (a Python number or a 0-d
    tensor), a float32 0-d tensor on the step's device (the CPU for a
    number). Computed in float32, as the reference computes it."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t))
    return warm * cos
