"""Port of ``repro/lifecycle/registry.py``: the versioned bundle registry,
the durable half of the promotion loop.

A :class:`BundleRegistry` owns a directory (``artifacts/bundles_torch/`` by
default: the port's own, where the reference's is ``artifacts/bundles/``)
holding immutable, versioned :class:`~repro_torch.engine.bundle
.SelectorBundle` artifacts plus one ``registry.json`` index with lineage
metadata, in the reference's index schema:

    <root>/registry.json          # index: serving pointer + entry list
    <root>/v0001-<fp12>.bundle    # immutable bundle payloads
    <root>/v0002-<fp12>.bundle

Each entry records *where a bundle came from* (``parent`` = the version
that was serving when it was registered, ``source`` = who registered it)
and *what happened to it* (``status``: candidate → serving → retired /
rolled_back, with promotion timestamps), so ``lineage()`` can answer "what
chain of retrains produced the model now in production" without the
training runs. Registration is content-addressed on the bundle
fingerprint — re-registering the same fitted state is a no-op returning
the existing entry, which is what makes ``SolverEngine.promote()``
idempotent about its incumbent.

Index updates are crash-safe (tmp + atomic replace) and cross-process
safe (the same advisory :class:`~repro_torch.core.locking.FileLock`
discipline the replica-shared plan cache uses), so N serving replicas can
share one registry the way they already share one disk cache tier.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Union

from ..core.locking import FileLock
from ..engine.bundle import SelectorBundle

__all__ = ["BundleRegistry", "BundleRegistryError", "DEFAULT_BUNDLE_DIR"]

DEFAULT_BUNDLE_DIR = os.path.join("artifacts", "bundles_torch")

_INDEX_SCHEMA = 1


class BundleRegistryError(RuntimeError):
    """Registry misuse: unknown version, rollback with no predecessor."""


def _empty_index() -> Dict[str, Any]:
    return {"schema": _INDEX_SCHEMA, "serving": None, "previous": None,
            "next_seq": 1, "entries": []}


class BundleRegistry:
    """Content-addressed, lineage-tracking store of selector bundles."""

    def __init__(self, root: str = DEFAULT_BUNDLE_DIR):
        self.root = root
        self._lock = FileLock(os.path.join(root, ".registry.lock"))

    # -- index I/O -----------------------------------------------------------
    @property
    def index_path(self) -> str:
        return os.path.join(self.root, "registry.json")

    def _read_index(self) -> Dict[str, Any]:
        try:
            with open(self.index_path, "r", encoding="utf-8") as f:
                idx = json.load(f)
        except (OSError, json.JSONDecodeError):
            return _empty_index()
        if idx.get("schema", 0) > _INDEX_SCHEMA:
            raise BundleRegistryError(
                f"registry index schema v{idx.get('schema')} is newer than "
                f"this build understands (v{_INDEX_SCHEMA})")
        return idx

    def _write_index(self, idx: Dict[str, Any]) -> None:
        os.makedirs(self.root, exist_ok=True)
        tmp = self.index_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(idx, f, indent=2, default=str)
        os.replace(tmp, self.index_path)

    @staticmethod
    def _find(idx: Dict[str, Any], version: str) -> Optional[Dict[str, Any]]:
        for e in idx["entries"]:
            if e["version"] == version:
                return e
        return None

    # -- registration --------------------------------------------------------
    def register(self, bundle: Union[SelectorBundle, str], *,
                 source: Optional[str] = None,
                 parent: Optional[str] = None,
                 notes: Optional[str] = None) -> Dict[str, Any]:
        """Add a bundle (object or path) to the registry; returns its entry.

        Content-addressed on the fingerprint: a bundle whose fitted state
        is already registered returns the existing entry untouched (the
        file is not rewritten). ``parent`` defaults to whatever version is
        serving at registration time — the lineage edge.
        """
        if isinstance(bundle, str):
            bundle = SelectorBundle.load(bundle)
        bundle.validate()
        with self._lock.exclusive():
            idx = self._read_index()
            for e in idx["entries"]:
                if e["fingerprint"] == bundle.fingerprint:
                    return dict(e)
            version = f"v{idx['next_seq']:04d}-{bundle.fingerprint[:12]}"
            idx["next_seq"] += 1
            path = os.path.join(self.root, f"{version}.bundle")
            bundle.save(path)
            entry = dict(
                version=version, path=path, status="candidate",
                parent=(parent if parent is not None else idx["serving"]),
                registered_unix=time.time(), promoted_unix=None,
                source=source, notes=notes, **bundle.describe())
            idx["entries"].append(entry)
            self._write_index(idx)
            return dict(entry)

    # -- lookup --------------------------------------------------------------
    def entries(self) -> List[Dict[str, Any]]:
        return [dict(e) for e in self._read_index()["entries"]]

    def entry(self, version: str) -> Dict[str, Any]:
        e = self._find(self._read_index(), version)
        if e is None:
            raise BundleRegistryError(
                f"no bundle version {version!r} in {self.root}")
        return dict(e)

    def load(self, version: str) -> SelectorBundle:
        """The validated bundle payload for a registered version."""
        return SelectorBundle.load(self.entry(version)["path"])

    def serving_version(self) -> Optional[str]:
        return self._read_index()["serving"]

    def previous_version(self) -> Optional[str]:
        return self._read_index()["previous"]

    def serving_entry(self) -> Optional[Dict[str, Any]]:
        idx = self._read_index()
        if idx["serving"] is None:
            return None
        e = self._find(idx, idx["serving"])
        return dict(e) if e is not None else None

    # -- serving pointer -----------------------------------------------------
    def mark_serving(self, version: str) -> Dict[str, Any]:
        """Atomically point ``serving`` at ``version`` (the promote step's
        registry half); the displaced version becomes ``previous`` (the
        rollback target) with status ``retired``."""
        with self._lock.exclusive():
            idx = self._read_index()
            entry = self._find(idx, version)
            if entry is None:
                raise BundleRegistryError(
                    f"cannot serve unregistered version {version!r}")
            prev = idx["serving"]
            if prev == version:
                return dict(entry)
            idx["previous"] = prev
            idx["serving"] = version
            entry["status"] = "serving"
            entry["promoted_unix"] = time.time()
            if prev is not None:
                pe = self._find(idx, prev)
                if pe is not None:
                    pe["status"] = "retired"
            self._write_index(idx)
            return dict(entry)

    def rollback(self) -> Dict[str, Any]:
        """Swap ``serving`` back to ``previous``; the demoted version is
        marked ``rolled_back`` (and becomes the new ``previous``, so a
        second rollback re-promotes it — the pointer swap is symmetric)."""
        with self._lock.exclusive():
            idx = self._read_index()
            prev = idx["previous"]
            if prev is None:
                raise BundleRegistryError(
                    "nothing to roll back to: no previous serving version")
            demoted = idx["serving"]
            idx["serving"], idx["previous"] = prev, demoted
            entry = self._find(idx, prev)
            if entry is None:
                raise BundleRegistryError(
                    f"previous version {prev!r} missing from the index")
            entry["status"] = "serving"
            if demoted is not None:
                de = self._find(idx, demoted)
                if de is not None:
                    de["status"] = "rolled_back"
            self._write_index(idx)
            return dict(entry)

    # -- lineage -------------------------------------------------------------
    def lineage(self, version: Optional[str] = None
                ) -> List[Dict[str, Any]]:
        """Parent chain starting at ``version`` (default: the serving
        version), newest first. Cycles (hand-edited indexes) terminate."""
        idx = self._read_index()
        v = version if version is not None else idx["serving"]
        chain: List[Dict[str, Any]] = []
        seen = set()
        while v is not None and v not in seen:
            seen.add(v)
            e = self._find(idx, v)
            if e is None:
                break
            chain.append(dict(e))
            v = e.get("parent")
        return chain

    def __len__(self) -> int:
        return len(self._read_index()["entries"])

    def __repr__(self) -> str:
        idx = self._read_index()
        return (f"BundleRegistry(root={self.root!r}, "
                f"entries={len(idx['entries'])}, "
                f"serving={idx['serving']!r})")
