"""Copy of ``repro/engine/registry.py``: the capability registries.

Everything the selection pipeline composes is a *named capability*:
reordering algorithms, classifier families, feature scalers, and feature
sets. Each lives in a :class:`Registry` — an ordered, metadata-carrying
mapping with decorator registration — so other orderings, models, or
feature sets plug in without editing core modules. Every lookup failure
raises :class:`RegistryLookupError` with did-you-mean suggestions.

The names match the reference's (``random_forest``, ``standard``,
``paper12``, …), because selector bundles name their parts by registry
name and load in either package. :class:`FeatureSet` carries a device
extractor ``extract_batch_device`` (padded CSR batch → ``(B, d)`` tensor)
where the reference has ``extract_batch_jnp``.

Stdlib only: core modules import it at definition time.
"""
from __future__ import annotations

import dataclasses
import difflib
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence)

__all__ = [
    "Registry", "RegistryEntry", "RegistryError", "DuplicateNameError",
    "RegistryLookupError", "FeatureSet",
    "REORDERING_REGISTRY", "MODEL_REGISTRY", "SCALER_REGISTRY",
    "FEATURE_SET_REGISTRY",
    "register_reordering", "register_model", "register_scaler",
    "register_feature_set", "get_feature_set",
]


class RegistryError(Exception):
    """Base class for registry failures."""


class DuplicateNameError(RegistryError, ValueError):
    """A name was registered twice without ``overwrite=True``."""


class RegistryLookupError(RegistryError, KeyError):
    """Unknown name, across *all* registries — one error type, with
    suggestions, so callers of any capability lookup handle one thing.

    Subclasses ``KeyError`` so legacy ``except KeyError`` call sites keep
    working.
    """

    def __init__(self, kind: str, name: Any, known: Sequence[str]):
        self.kind = kind
        self.name = name
        self.known = sorted(known)
        msg = f"unknown {kind} {name!r}; available: {self.known}"
        if isinstance(name, str) and self.known:
            close = difflib.get_close_matches(name, self.known, n=3)
            if close:
                msg += f" — did you mean {' / '.join(map(repr, close))}?"
        super().__init__(msg)

    def __str__(self) -> str:  # KeyError.__str__ repr()s the message
        return self.args[0]


def _same_provenance(a: Any, b: Any) -> bool:
    """True when ``b`` is a reload of ``a``: same definition site (module +
    qualname for classes/functions; FeatureSets compare their extractors)."""
    if isinstance(a, FeatureSet) and isinstance(b, FeatureSet):
        return a.name == b.name and _same_provenance(a.extract, b.extract)
    qa = (getattr(a, "__module__", None), getattr(a, "__qualname__", None))
    qb = (getattr(b, "__module__", None), getattr(b, "__qualname__", None))
    return None not in qa and qa == qb


@dataclasses.dataclass(frozen=True)
class RegistryEntry:
    """One registered capability: the object plus its metadata."""

    name: str
    obj: Any
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Registry(Mapping):
    """Ordered name → capability mapping with decorator registration.

    ``registry[name]`` returns the registered object (class or callable);
    ``registry.spec(name)`` returns the full :class:`RegistryEntry` with
    metadata (e.g. ``category``, ``device_capable``, ``symmetric_only``).
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: "Dict[str, RegistryEntry]" = {}

    # -- registration --------------------------------------------------------
    def register(self, name: str, obj: Any = None, *, overwrite: bool = False,
                 **metadata: Any):
        """Register ``obj`` under ``name``; usable as a decorator.

        ``@registry.register("x", category="y")`` decorates a class or
        function; ``registry.register("x", obj)`` registers directly.
        Re-registering a taken name raises :class:`DuplicateNameError`
        unless ``overwrite=True``. Re-registering the *same* object — or a
        fresh object with the same module + qualname, which is what
        ``importlib.reload`` produces — replaces silently, so reloads and
        re-imports stay harmless while genuinely conflicting names fail.
        """

        def _add(target):
            prior = self._entries.get(name)
            if (prior is not None and prior.obj is not target
                    and not overwrite
                    and not _same_provenance(prior.obj, target)):
                raise DuplicateNameError(
                    f"{self.kind} {name!r} is already registered "
                    f"(to {prior.obj!r}); pass overwrite=True to replace it")
            self._entries[name] = RegistryEntry(name, target, dict(metadata))
            return target

        if obj is None:
            return _add
        return _add(obj)

    def unregister(self, name: str) -> None:
        self._entries.pop(name, None)

    # -- lookup --------------------------------------------------------------
    def __getitem__(self, name: str) -> Any:
        try:
            return self._entries[name].obj
        except KeyError:
            # `from None`: the internal KeyError is noise — the caller
            # should see one clean frame, not a chained traceback
            raise RegistryLookupError(self.kind, name, self._entries) from None

    def spec(self, name: str) -> RegistryEntry:
        if name not in self._entries:
            raise RegistryLookupError(self.kind, name, self._entries)
        return self._entries[name]

    def metadata(self, name: str) -> Dict[str, Any]:
        return dict(self.spec(name).metadata)

    def name_of(self, obj: Any) -> str:
        """Reverse lookup: the name ``obj`` (or its class) is registered
        under — how bundles record which registry entry rebuilds them."""
        cls = obj if isinstance(obj, type) else type(obj)
        for e in self._entries.values():
            if e.obj is obj or e.obj is cls:
                return e.name
        raise RegistryLookupError(self.kind, getattr(cls, "__name__", obj),
                                  self._entries)

    # -- Mapping protocol (legacy dict compatibility) ------------------------
    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, name: object) -> bool:
        return name in self._entries

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, {sorted(self._entries)})"


# ---------------------------------------------------------------------------
# Feature sets
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FeatureSet:
    """A named feature schema plus its extraction paths.

    ``names`` is the schema (order matters — it is persisted in bundles and
    validated on load). ``extract`` maps one matrix to a ``(d,)`` vector;
    ``extract_batch`` maps a sequence to ``(B, d)`` on the host;
    ``extract_batch_device`` (optional) consumes a padded CSR batch and
    returns a ``(B, d)`` tensor on the device — selection with a feature
    set without one featurizes on the host.
    """

    name: str
    names: Sequence[str]
    extract: Callable
    extract_batch: Optional[Callable] = None
    extract_batch_device: Optional[Callable] = None

    @property
    def dim(self) -> int:
        return len(self.names)

    def batch(self, mats) -> Any:
        if self.extract_batch is not None:
            return self.extract_batch(mats)
        import numpy as np
        return np.stack([self.extract(m) for m in mats])

    @property
    def device_capable(self) -> bool:
        return self.extract_batch_device is not None


# ---------------------------------------------------------------------------
# The four registries + their decorator front-ends
# ---------------------------------------------------------------------------

REORDERING_REGISTRY = Registry("reordering")
MODEL_REGISTRY = Registry("model")
SCALER_REGISTRY = Registry("scaler")
FEATURE_SET_REGISTRY = Registry("feature set")


def register_reordering(name: str, *, category: str = "uncategorized",
                        symmetric_only: bool = True,
                        device_capable: bool = False, **metadata):
    """Decorator: register a ``CSRMatrix -> perm`` callable."""
    return REORDERING_REGISTRY.register(
        name, category=category, symmetric_only=symmetric_only,
        device_capable=device_capable, **metadata)


def register_model(name: str, *, device_capable: bool = False, **metadata):
    """Decorator: register a :class:`BaseClassifier` subclass.

    ``device_capable`` marks families whose fitted instances expose
    ``forward_device`` (inference runs on the card).
    """
    return MODEL_REGISTRY.register(name, device_capable=device_capable,
                                   **metadata)


def register_scaler(name: str, **metadata):
    """Decorator: register a scaler class (fit/transform/state/load_state)."""
    return SCALER_REGISTRY.register(name, **metadata)


def register_feature_set(name: str, *, names: Sequence[str],
                         extract: Optional[Callable] = None,
                         extract_batch: Optional[Callable] = None,
                         extract_batch_device: Optional[Callable] = None,
                         **metadata):
    """Register a feature schema + extractors; decorator over ``extract``.

    Called with ``extract=``, registers immediately; without it, returns a
    decorator for the single-matrix extractor.
    """

    def _add(extract_fn):
        fs = FeatureSet(name, list(names), extract_fn, extract_batch,
                        extract_batch_device)
        FEATURE_SET_REGISTRY.register(name, fs,
                                      device_capable=fs.device_capable,
                                      dim=fs.dim, **metadata)
        return extract_fn

    if extract is None:
        return _add
    _add(extract)
    return FEATURE_SET_REGISTRY[name]


def get_feature_set(name: str) -> FeatureSet:
    """The registered :class:`FeatureSet`, importing the default providers
    first so lookups work before any explicit ``repro_torch.core`` import."""
    from ..core import features  # noqa: F401  (registers paper12/extended19)
    return FEATURE_SET_REGISTRY[name]
