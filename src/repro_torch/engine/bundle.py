"""Port of ``repro/engine/bundle.py``: :class:`SelectorBundle`, the
persistence format of trained selectors.

A bundle is a *schema-versioned envelope of plain data*:

    schema version + feature schema (set name + ordered feature names)
    + algorithm list + model (registry name, hyperparameters, fitted state
    via ``state()``) + scaler (registry name, fitted state) + fingerprint

Loading validates everything before any object is built: the schema
version, that the model/scaler/feature-set names resolve in their
registries, that the stored feature names match the registered feature
set's schema, and that the stored fingerprint matches the recomputed one
(corruption check).

The envelope on disk is the reference's: a pickle of dicts, lists and numpy
arrays under the magic string ``"repro.engine.SelectorBundle"``, with the
same field names and the same fingerprint, so a bundle written by either
package loads in the other. A raw pickled ``ReorderSelector`` (the
reference's pre-bundle format) names the reference's classes and is
refused.

**Schema v2** carries two *descriptive* sections — ``report_card`` (held-out
test accuracy, per-algorithm recall, confusion matrix) and ``provenance``
(what dataset the selector was trained on). Both are excluded from the
fingerprint: they describe the fitted behaviour, they don't change it. v1
bundles (no such sections) load with both set to ``None``. ``describe()``
is the compact summary the bundle registry indexes.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Any, Dict, List, Optional

from .fingerprint import fingerprint_state
from .registry import (FEATURE_SET_REGISTRY, MODEL_REGISTRY, SCALER_REGISTRY,
                       get_feature_set)

__all__ = ["SelectorBundle", "BundleValidationError",
           "BUNDLE_SCHEMA_VERSION"]

BUNDLE_SCHEMA_VERSION = 2

_MAGIC = "repro.engine.SelectorBundle"


class BundleValidationError(RuntimeError):
    """A bundle failed load-time validation (schema / registry / schema
    mismatch / corruption)."""


def _ensure_default_registrations() -> None:
    """Bundles resolve by registry name; make sure the in-tree providers
    have registered before lookups (other entries must already be imported
    by the caller, exactly like any plugin system)."""
    from ..core import features, ml, scaling  # noqa: F401
    from ..sparse import reorder  # noqa: F401


@dataclasses.dataclass
class SelectorBundle:
    """Schema-versioned, fingerprinted, registry-resolvable selector state."""

    model_name: str
    model_params: Dict[str, Any]
    model_state: Dict[str, Any]
    scaler_name: str
    scaler_state: Dict[str, Any]
    feature_set: str
    feature_names: List[str]
    algorithms: List[str]
    fingerprint: str = ""
    schema_version: int = BUNDLE_SCHEMA_VERSION
    created_unix: float = 0.0
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # -- schema v2: descriptive sections (fingerprint-exempt) ---------------
    # training-report card: {test_accuracy, cv_score, best_params,
    # per_algorithm_recall: {alg: recall}, confusion: [[...]] (rows =
    # true algorithm, cols = predicted, over the held-out split),
    # test_support: {alg: count}}. None on v1 bundles and untrained saves.
    report_card: Optional[Dict[str, Any]] = None
    # dataset provenance: {n_samples, algorithms, feature_set, groups,
    # dim_range, nnz_range, label_counts}. None on v1 bundles.
    provenance: Optional[Dict[str, Any]] = None

    # -- identity ------------------------------------------------------------
    def compute_fingerprint(self) -> str:
        """Deterministic hash of everything behaviour-relevant. Computable
        from the envelope alone (no live objects), so a loaded bundle can be
        integrity-checked and the engine can version its plan cache off the
        same value it would get from the live selector."""
        return fingerprint_state({
            "model_name": self.model_name,
            "model_params": self.model_params,
            "model_state": self.model_state,
            "scaler_name": self.scaler_name,
            "scaler_state": self.scaler_state,
            "feature_set": self.feature_set,
            "feature_names": list(self.feature_names),
            "algorithms": list(self.algorithms),
        })

    # -- conversion ----------------------------------------------------------
    @classmethod
    def from_selector(cls, selector, meta: Optional[Dict[str, Any]] = None,
                      report_card: Optional[Dict[str, Any]] = None,
                      provenance: Optional[Dict[str, Any]] = None
                      ) -> "SelectorBundle":
        """Snapshot a fitted
        :class:`repro_torch.core.selector.ReorderSelector`.

        ``report_card``/``provenance`` are the v2 descriptive sections
        (``SolverEngine.save`` fills them from its last training run);
        omitted, the bundle is still a valid v2 envelope with both None.
        """
        _ensure_default_registrations()
        fs_name = getattr(selector, "feature_set", "paper12")
        fs = get_feature_set(fs_name)
        b = cls(
            model_name=MODEL_REGISTRY.name_of(selector.model),
            model_params=dict(getattr(selector.model, "params", {})),
            model_state=selector.model.state(),
            scaler_name=SCALER_REGISTRY.name_of(selector.scaler),
            scaler_state=selector.scaler.state(),
            feature_set=fs_name,
            feature_names=list(fs.names),
            algorithms=list(selector.algorithms),
            created_unix=time.time(),
            meta=dict(meta or {}),
            report_card=report_card,
            provenance=provenance,
        )
        b.fingerprint = b.compute_fingerprint()
        return b

    def to_selector(self):
        """Rebuild a ready-to-serve ``ReorderSelector`` (validates first)."""
        from ..core.selector import ReorderSelector

        self.validate()
        model = MODEL_REGISTRY[self.model_name](**self.model_params)
        model.load_state(self.model_state)
        scaler = SCALER_REGISTRY[self.scaler_name]()
        scaler.load_state(self.scaler_state)
        return ReorderSelector(model, scaler, list(self.algorithms),
                               feature_set=self.feature_set)

    # -- validation ----------------------------------------------------------
    def validate(self) -> "SelectorBundle":
        _ensure_default_registrations()
        if self.schema_version > BUNDLE_SCHEMA_VERSION:
            raise BundleValidationError(
                f"bundle schema v{self.schema_version} is newer than this "
                f"build understands (v{BUNDLE_SCHEMA_VERSION})")
        for registry, name in ((MODEL_REGISTRY, self.model_name),
                               (SCALER_REGISTRY, self.scaler_name),
                               (FEATURE_SET_REGISTRY, self.feature_set)):
            if name not in registry:
                raise BundleValidationError(
                    f"bundle references unknown {registry.kind} {name!r}; "
                    f"available: {sorted(registry)}")
        fs = FEATURE_SET_REGISTRY[self.feature_set]
        if list(self.feature_names) != list(fs.names):
            raise BundleValidationError(
                f"bundle feature schema does not match registered feature "
                f"set {self.feature_set!r}: bundle has "
                f"{list(self.feature_names)}, registry has {list(fs.names)}")
        if self.fingerprint and self.fingerprint != self.compute_fingerprint():
            raise BundleValidationError(
                "bundle fingerprint mismatch — the payload was modified "
                "after save (or the file is corrupt)")
        if self.report_card is not None:
            conf = self.report_card.get("confusion")
            k = len(self.algorithms)
            if conf is not None and (len(conf) != k
                                     or any(len(row) != k for row in conf)):
                raise BundleValidationError(
                    f"report card confusion matrix is not {k}x{k} for "
                    f"algorithms {list(self.algorithms)}")
        return self

    def describe(self) -> Dict[str, Any]:
        """Compact plain-data summary (what the bundle registry indexes):
        identity + capability names + the headline quality numbers, never
        the fitted state."""
        return dict(
            fingerprint=self.fingerprint,
            schema_version=self.schema_version,
            model=self.model_name,
            scaler=self.scaler_name,
            feature_set=self.feature_set,
            algorithms=list(self.algorithms),
            created_unix=self.created_unix,
            test_accuracy=(self.report_card or {}).get("test_accuracy"),
            n_samples=(self.provenance or {}).get("n_samples"),
        )

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> str:
        payload = dataclasses.asdict(self)
        envelope = {"magic": _MAGIC,
                    "schema_version": self.schema_version,
                    "bundle": payload}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(envelope, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
        return path

    @classmethod
    def from_envelope(cls, obj: Dict[str, Any]) -> "SelectorBundle":
        """Validated bundle from an already-unpickled envelope dict."""
        fields = {f.name for f in dataclasses.fields(cls)}
        payload = {k: v for k, v in obj["bundle"].items() if k in fields}
        return cls(**payload).validate()

    @classmethod
    def load(cls, path: str) -> "SelectorBundle":
        with open(path, "rb") as f:
            obj = pickle.load(f)
        if isinstance(obj, dict) and obj.get("magic") == _MAGIC:
            return cls.from_envelope(obj)
        raise BundleValidationError(
            f"{path} is not a SelectorBundle envelope (got "
            f"{type(obj).__name__})")
