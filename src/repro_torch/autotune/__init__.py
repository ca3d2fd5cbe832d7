"""Port of ``repro/autotune/__init__.py``: learned execution-plan
selection — the paper's technique generalized — and the measured solve
tuner.

The paper: features(sparse matrix) → best reordering algorithm.
Here:      features(arch × shape × mesh) → best ExecutionPlan.

Same supervised machinery (:mod:`repro_torch.core.ml`), different domain:
the training corpus is the dry run's record table
(:mod:`repro_torch.launch.dryrun`: roofline terms and memory per plan),
labels are the plan with the best dominant-term/residency trade-off per
cell. See :class:`~repro_torch.autotune.plan_selector.PlanSelector`.

:mod:`~repro_torch.autotune.solve_tuner` is the measured (not learned)
sibling for the numeric solve backends: it searches the panel-width cap
and bucket pad policy (and the device sweep's knobs) per device kind, and
persists the winner under ``artifacts/autotune_torch/``.
"""
from .plan_selector import (CANDIDATE_PLANS, PlanSelector, plan_label,
                            workload_features)
from .solve_tuner import (DEFAULT_AUTOTUNE_DIR, SolvePolicy, get_policy,
                          load_policy, save_policy, tune)

__all__ = ["CANDIDATE_PLANS", "PlanSelector", "plan_label",
           "workload_features", "SolvePolicy", "DEFAULT_AUTOTUNE_DIR",
           "get_policy", "load_policy", "save_policy", "tune"]
