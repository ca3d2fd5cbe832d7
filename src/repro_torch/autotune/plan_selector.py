"""Port of ``repro/autotune/plan_selector.py``: execution-plan selection
from workload features (``WORKLOAD_FEATURE_NAMES`` :27, ``CANDIDATE_PLANS``
:34, ``plan_label`` :50, ``workload_features`` :57, ``_score`` :75,
``load_artifacts`` :89, ``PlanSelector`` :97).

``workload_features`` mirrors the paper's Table 3 for the LM domain: cheap
static descriptors of the (arch, shape, mesh) cell. ``PlanSelector`` trains
any :mod:`repro_torch.core.ml` classifier on the dry run's records
(``artifacts/dryrun_torch/**.json``, :mod:`repro_torch.launch.dryrun`, one
per cell × plan tag) and predicts the best plan for unseen cells; when
fewer than ``min_samples`` cells have a choice to learn from it falls back
to an analytic rule set (the defaults a MaxText-style config would ship).

One deliberate divergence: the reference prices residency against v5e's
16 GB (the overflow penalty of ``_score``) and calls a model's parameters
too large for one chip above a quarter of that (``_analytic_rule``).
Here both read ``hbm_bytes``, by default the card's
(:data:`repro_torch.device.HBM_BYTES`); passing the reference's 16 GB
gives the reference's choices.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..configs import get_config
from ..core.ml import MODEL_ZOO
from ..core.scaling import StandardScaler
from ..device import HBM_BYTES
from ..distributed.sharding import ExecutionPlan
from ..models.config import SHAPES, ModelConfig, ShapeSpec

__all__ = ["workload_features", "CANDIDATE_PLANS", "plan_label",
           "PlanSelector", "WORKLOAD_FEATURE_NAMES", "load_artifacts"]

WORKLOAD_FEATURE_NAMES = [
    "num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
    "log_vocab", "num_experts", "experts_per_token", "is_ssm", "is_hybrid",
    "log_seq", "log_batch", "log_tokens", "is_train", "is_decode",
    "n_data", "n_model", "log_params", "log_active_params",
]

CANDIDATE_PLANS: Dict[str, ExecutionPlan] = {
    "baseline": ExecutionPlan(),
    "fsdp": ExecutionPlan(fsdp_params=True),
    "fsdp_ep": ExecutionPlan(fsdp_params=True, moe_impl="ep"),
    "ep": ExecutionPlan(moe_impl="ep"),
    "no_remat": ExecutionPlan(remat="none"),
    "small_chunks": ExecutionPlan(attn_q_chunk=512, attn_kv_chunk=512),
    "pure_dp": ExecutionPlan(pure_dp=True, fsdp_params=True),
    # plans discovered/validated in the §Perf hillclimb
    "fsdp_actshard": ExecutionPlan(fsdp_params=True,
                                   shard_activation_ckpt=True),
    "seqshard_decode": ExecutionPlan(seq_shard_decode=True),
}


def plan_label(plan_dict: dict) -> str:
    """The candidate whose every field ``plan_dict`` matches, else
    ``"custom"``. Keys the port's plan lacks (the reference's
    ``scan_layers``) are not compared."""
    for name, plan in CANDIDATE_PLANS.items():
        if all(plan_dict.get(k) == v for k, v in plan.__dict__.items()):
            return name
    return "custom"


def workload_features(cfg: ModelConfig, shape: ShapeSpec, n_data: int,
                      n_model: int) -> np.ndarray:
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    return np.array([
        cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
        cfg.d_ff, np.log1p(cfg.vocab_size), cfg.num_experts,
        cfg.experts_per_token,
        float(any(k in ("M", "s") for k in cfg.block_pattern)),
        float("m" in cfg.block_pattern),
        np.log1p(shape.seq_len), np.log1p(shape.global_batch),
        np.log1p(tokens), float(shape.kind == "train"),
        float(shape.kind == "decode"), n_data, n_model,
        np.log1p(cfg.param_count()), np.log1p(cfg.active_param_count()),
    ], dtype=np.float64)


def _score(record: dict, hbm_bytes: float = HBM_BYTES) -> float:
    """Lower is better: dominant roofline term, with a penalty
    proportional to the overflow past ``hbm_bytes`` (a plan that does not
    fit cannot run, whatever its FLOP schedule says). A record whose
    status is not ``ok`` scores infinite."""
    if record.get("status") != "ok":
        return float("inf")
    r = record["roofline"]
    dom = max(r["compute_s"], r["memory_s"], r["collective_s"])
    resident = record.get("resident_bytes", 0)
    overflow = max(0.0, resident - hbm_bytes) / hbm_bytes
    return dom * (1.0 + 4.0 * overflow)


def load_artifacts(art_dir: str = "artifacts/dryrun_torch") -> List[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(art_dir, "*", "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


class PlanSelector:
    def __init__(self, model_name: str = "random_forest",
                 min_samples: int = 12, hbm_bytes: float = HBM_BYTES):
        self.model_name = model_name
        self.min_samples = min_samples
        self.hbm_bytes = hbm_bytes
        self.model = None
        self.scaler = None
        self.plan_names: List[str] = []

    # -- training corpus from artifacts ---------------------------------------
    def build_dataset(self, artifacts: Sequence[dict]
                      ) -> Tuple[np.ndarray, np.ndarray]:
        by_cell: Dict[Tuple[str, str, str], Dict[str, dict]] = {}
        for rec in artifacts:
            if "roofline" not in rec and rec.get("status") != "ok":
                if "plan" not in rec:
                    continue
            key = (rec["arch"], rec["shape"], rec["mesh"])
            by_cell.setdefault(key, {})[plan_label(rec.get("plan", {}))] = rec
        feats, labels = [], []
        self.plan_names = sorted(CANDIDATE_PLANS)
        for (arch, shape_name, mesh_name), plans in by_cell.items():
            scored = {p: _score(r, self.hbm_bytes) for p, r in plans.items()
                      if p in self.plan_names
                      and _score(r, self.hbm_bytes) < float("inf")}
            if len(scored) < 2:
                continue  # need at least two plans to have a choice
            best = min(scored, key=scored.get)
            cfg = get_config(arch)
            shape = SHAPES[shape_name]
            n_model = 16
            n_data = 32 if "2x16" in mesh_name else 16
            feats.append(workload_features(cfg, shape, n_data, n_model))
            labels.append(self.plan_names.index(best))
        if not feats:
            return np.zeros((0, len(WORKLOAD_FEATURE_NAMES))), np.zeros(0, int)
        return np.stack(feats), np.array(labels)

    def fit(self, artifacts: Optional[Sequence[dict]] = None,
            art_dir: str = "artifacts/dryrun_torch") -> "PlanSelector":
        arts = list(artifacts) if artifacts is not None else load_artifacts(art_dir)
        x, y = self.build_dataset(arts)
        if x.shape[0] >= self.min_samples and np.unique(y).size >= 2:
            self.scaler = StandardScaler().fit(x)
            self.model = MODEL_ZOO[self.model_name](n_estimators=50)
            self.model.fit(self.scaler.transform(x), y)
        return self

    # -- inference --------------------------------------------------------------
    def _analytic_rule(self, cfg: ModelConfig, shape: ShapeSpec,
                       n_data: int) -> str:
        if shape.kind != "train":
            return "baseline"
        # params won't comfortably fit: more than a quarter of the memory
        if cfg.param_count() * 2 / 16 > self.hbm_bytes / 4:
            return "fsdp_ep" if cfg.num_experts else "fsdp"
        return "baseline"

    def recommend(self, cfg: ModelConfig, shape: ShapeSpec, n_data: int,
                  n_model: int) -> Tuple[str, ExecutionPlan]:
        if self.model is None:
            name = self._analytic_rule(cfg, shape, n_data)
            return name, CANDIDATE_PLANS[name]
        f = workload_features(cfg, shape, n_data, n_model)[None]
        idx = int(self.model.predict(self.scaler.transform(f))[0])
        name = self.plan_names[idx]
        return name, CANDIDATE_PLANS[name]
