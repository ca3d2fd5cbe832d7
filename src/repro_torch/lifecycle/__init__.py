"""Port of ``repro/lifecycle/__init__.py``: the bundle lifecycle control
plane, campaign → shadow → promote → rollback.

The ML-ops layer that turns the repo from "a model we trained once" into a
continuously-trainable serving system:

* :mod:`repro_torch.lifecycle.campaign` — sharded, resumable labeling
  campaigns over the (matrix × reordering algorithm) grid, with per-matrix
  JSON artifacts and a ``BENCH_campaign.json`` report.
* :mod:`repro_torch.lifecycle.shadow` — a candidate bundle shadow-serves
  next to the incumbent, scored by agreement and counterfactual
  predicted-flops win rate, entirely off the hot path.
* :mod:`repro_torch.lifecycle.promote` — the configurable promotion gate
  (report-card accuracy + shadow win rate) with typed rejections.
* :mod:`repro_torch.lifecycle.registry` — versioned bundles under
  ``artifacts/bundles_torch/`` with lineage metadata and the
  serving/previous pointers that ``SolverEngine.promote()`` / ``rollback()`` swap.
"""
# PEP 562 lazy re-exports (the engine package's idiom): importing the
# package must not import every submodule — `python -m
# repro_torch.lifecycle.campaign` would otherwise warn about the module
# being in sys.modules pre-exec
_LAZY = {
    "BundleRegistry": "registry", "BundleRegistryError": "registry",
    "DEFAULT_BUNDLE_DIR": "registry",
    "PromotionGate": "promote", "PromotionError": "promote",
    "NotPromotable": "promote", "GateRejected": "promote",
    "evaluate_gate": "promote",
    "ShadowEvaluator": "shadow",
    "CampaignConfig": "campaign", "CampaignResult": "campaign",
    "run_campaign": "campaign", "assemble_dataset": "campaign",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
