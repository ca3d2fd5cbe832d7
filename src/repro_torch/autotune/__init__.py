"""Port of ``repro/autotune/__init__.py``: the measured solve tuner.

:mod:`~repro_torch.autotune.solve_tuner` searches the numeric backends'
panel-width cap and bucket pad policy (and the device sweep's knobs) per
device kind, and persists the winner under ``artifacts/autotune_torch/``.

The learned plan selector of the reference (``plan_selector``: features of
arch × shape × mesh → execution plan) is not ported here; it is ROADMAP
item 3.3.
"""
from .solve_tuner import (DEFAULT_AUTOTUNE_DIR, SolvePolicy, get_policy,
                          load_policy, save_policy, tune)

__all__ = ["SolvePolicy", "DEFAULT_AUTOTUNE_DIR", "get_policy",
           "load_policy", "save_policy", "tune"]
