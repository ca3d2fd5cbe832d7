"""Port of ``repro/engine/__init__.py``: the single API of the paper's
deliverable::

    from repro_torch.engine import EngineConfig, SolverEngine

    engine = SolverEngine(EngineConfig())
    engine.train(dataset)              # grid-search + refit, fingerprinted
    names = engine.select_batch(mats)  # featurize + classify on the card
    results = engine.solve_batch(mats, bs)  # select → plan → solve
    server = engine.serve()            # AsyncPlanServer bound to the engine
    engine.save("selector.bundle")     # versioned SelectorBundle artifact
    engine = SolverEngine.load("selector.bundle")
    engine.start_shadow("candidate.bundle")  # score a retrained candidate
    engine.promote()                   # gated swap (repro_torch.lifecycle)
    engine.rollback()                  # back to the previous bundle

The registry surface imports eagerly (stdlib only); the facade classes load
lazily on first attribute access, so core modules can import the registries
without cycles.
"""
from .registry import (FEATURE_SET_REGISTRY, MODEL_REGISTRY,
                       REORDERING_REGISTRY, SCALER_REGISTRY,
                       DuplicateNameError, FeatureSet, Registry,
                       RegistryEntry, RegistryError, RegistryLookupError,
                       get_feature_set, register_feature_set, register_model,
                       register_reordering, register_scaler)

__all__ = [
    # registries
    "Registry", "RegistryEntry", "RegistryError", "DuplicateNameError",
    "RegistryLookupError", "FeatureSet",
    "REORDERING_REGISTRY", "MODEL_REGISTRY", "SCALER_REGISTRY",
    "FEATURE_SET_REGISTRY",
    "register_reordering", "register_model", "register_scaler",
    "register_feature_set", "get_feature_set",
    # fingerprints
    "fingerprint_state", "component_fingerprint", "combine_fingerprints",
    # facade (lazy)
    "EngineConfig", "SolverEngine", "EngineError",
    "SelectorBundle", "BundleValidationError", "BUNDLE_SCHEMA_VERSION",
]

_LAZY = {
    "fingerprint_state": "fingerprint",
    "component_fingerprint": "fingerprint",
    "combine_fingerprints": "fingerprint",
    "EngineConfig": "config",
    "SolverEngine": "core",
    "EngineError": "core",
    "SelectorBundle": "bundle",
    "BundleValidationError": "bundle",
    "BUNDLE_SCHEMA_VERSION": "bundle",
}


def __getattr__(name):  # PEP 562: facade classes resolve on first touch
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
