"""Port of ``repro/lifecycle/promote.py``: the promotion gate, the policy
between "retrained candidate" and "serving".

A candidate bundle replaces the incumbent only when it clears two
independent kinds of evidence:

* **Report card** (offline): the bundle's schema-v2 training report must
  exist and its held-out ``test_accuracy`` must clear
  ``min_test_accuracy``. A schema-v1 bundle — or a v2 bundle saved without
  training — carries no report card and is *never* auto-promotable
  (:class:`NotPromotable`): it may still be loaded and served explicitly,
  but the automated loop refuses to swap production onto a model whose
  quality was never measured.
* **Shadow traffic** (online): the candidate must have shadow-served at
  least ``min_shadow_requests`` real requests next to the incumbent
  (:mod:`repro_torch.lifecycle.shadow`) and its counterfactual
  predicted-flops win rate must clear ``min_shadow_win_rate``. ``require_shadow=False``
  turns the online half off (offline-only promotion, e.g. bootstrap).

:func:`evaluate_gate` is pure policy — it inspects a bundle and a shadow
stats dict and either returns a decision record (every check with its
measured value and threshold) or raises the typed error; the engine's
``promote()`` does the cache-consistent swap only after the gate passes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ..engine.bundle import SelectorBundle

__all__ = ["PromotionGate", "PromotionError", "NotPromotable",
           "GateRejected", "evaluate_gate"]


class PromotionError(RuntimeError):
    """Base of the typed promotion-path errors."""


class NotPromotable(PromotionError):
    """The candidate can never pass the gate as-is (no report card — a
    schema-v1 bundle or an untrained save). Distinct from
    :class:`GateRejected`: no amount of shadow traffic fixes this."""


class GateRejected(PromotionError):
    """The candidate failed one or more gate thresholds. Carries the full
    ``decision`` record (every check, measured vs required) so callers and
    logs can see exactly which check failed by how much."""

    def __init__(self, message: str, decision: Dict[str, Any]):
        super().__init__(message)
        self.decision = decision


@dataclasses.dataclass(frozen=True)
class PromotionGate:
    """Configurable promotion thresholds (see module docstring)."""

    min_test_accuracy: float = 0.5
    min_shadow_requests: int = 10
    min_shadow_win_rate: float = 0.5
    require_shadow: bool = True

    @classmethod
    def from_config(cls, config) -> "PromotionGate":
        """Thresholds from an
        :class:`repro_torch.engine.config.EngineConfig`."""
        return cls(
            min_test_accuracy=config.promote_min_accuracy,
            min_shadow_requests=config.promote_min_shadow_requests,
            min_shadow_win_rate=config.promote_min_win_rate)


def _check(name: str, value, threshold, ok: bool) -> Dict[str, Any]:
    return dict(check=name, value=value, threshold=threshold,
                passed=bool(ok))


def evaluate_gate(candidate: SelectorBundle, gate: PromotionGate,
                  shadow_stats: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """Run every gate check against a candidate; the decision record.

    Raises :class:`NotPromotable` (no report card) or
    :class:`GateRejected` (threshold failures, all listed); returns the
    decision dict — ``{fingerprint, passed: True, checks: [...]}`` — when
    the candidate clears the gate.
    """
    if candidate.report_card is None:
        raise NotPromotable(
            f"bundle {candidate.fingerprint[:12]} (schema "
            f"v{candidate.schema_version}) has no training report card — "
            "legacy v1 bundles and untrained saves cannot be auto-promoted; "
            "retrain and re-save through SolverEngine.train()/save() to get "
            "a v2 report card, or serve it explicitly via SolverEngine.load()")

    checks: List[Dict[str, Any]] = []
    acc = candidate.report_card.get("test_accuracy")
    checks.append(_check(
        "report_card.test_accuracy", acc, gate.min_test_accuracy,
        acc is not None and float(acc) >= gate.min_test_accuracy))

    if gate.require_shadow:
        evaluated = 0 if shadow_stats is None else int(
            shadow_stats.get("evaluated", 0))
        win_rate = None if shadow_stats is None else shadow_stats.get(
            "win_rate")
        checks.append(_check(
            "shadow.evaluated", evaluated, gate.min_shadow_requests,
            evaluated >= gate.min_shadow_requests))
        checks.append(_check(
            "shadow.win_rate", win_rate, gate.min_shadow_win_rate,
            win_rate is not None
            and float(win_rate) >= gate.min_shadow_win_rate))

    decision = dict(fingerprint=candidate.fingerprint,
                    passed=all(c["passed"] for c in checks), checks=checks,
                    gate=dataclasses.asdict(gate))
    if not decision["passed"]:
        failed = ", ".join(
            f"{c['check']}={c['value']!r} (need ≥ {c['threshold']!r})"
            for c in checks if not c["passed"])
        raise GateRejected(
            f"candidate {candidate.fingerprint[:12]} rejected by the "
            f"promotion gate: {failed}", decision)
    return decision
