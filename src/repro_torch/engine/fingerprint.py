"""Copy of ``repro/engine/fingerprint.py``: deterministic fingerprints of
fitted state. The bytes hashed are the reference's, so a fingerprint
computed here equals the reference's for the same state.

A *fingerprint* is a short stable hash of everything that determines a
component's input→output behaviour: class identity, hyperparameters, and
fitted state. The engine threads the fingerprint of its (model, scaler,
feature set, algorithm list) into the plan cache as the cache version, so
retraining — which changes the fitted state, hence the fingerprint —
automatically makes every previously persisted plan invisible. No manual
cache-version bump, no stale plans served by a freshly retrained
selector.

Hashing canonicalizes recursively: dicts by sorted key, sequences in
order, arrays as dtype + shape + raw bytes (other array types are pulled
to the host first), scalars/strings by repr. Anything unrecognized falls back to
``pickle.dumps`` — deterministic for the plain object graphs that appear in
model state.
"""
from __future__ import annotations

import hashlib
import numbers
import pickle
from typing import Any

__all__ = ["canonical_bytes", "fingerprint_state", "component_fingerprint",
           "combine_fingerprints"]

_DIGEST_SIZE = 16


def _update(h, obj: Any) -> None:
    import numpy as np

    if obj is None:
        h.update(b"\x00none")
    elif isinstance(obj, (bool, numbers.Integral)):
        h.update(b"\x01int" + repr(int(obj)).encode())
    elif isinstance(obj, numbers.Real):
        h.update(b"\x02flt" + repr(float(obj)).encode())
    elif isinstance(obj, str):
        h.update(b"\x03str" + obj.encode())
    elif isinstance(obj, bytes):
        h.update(b"\x04byt" + obj)
    elif isinstance(obj, dict):
        h.update(b"\x05map" + repr(len(obj)).encode())
        for k in sorted(obj, key=repr):
            _update(h, k)
            _update(h, obj[k])
    elif isinstance(obj, (list, tuple)):
        h.update(b"\x06seq" + repr(len(obj)).encode())
        for v in obj:
            _update(h, v)
    else:
        arr = None
        if isinstance(obj, np.ndarray):
            arr = obj
        elif hasattr(obj, "__array__") and hasattr(obj, "dtype"):
            arr = np.asarray(obj)  # host transfer of other array types
        if arr is not None:
            h.update(b"\x07arr" + str(arr.dtype).encode()
                     + repr(arr.shape).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
        else:
            h.update(b"\x08pkl" + pickle.dumps(obj, protocol=4))


def canonical_bytes(obj: Any) -> bytes:
    """Canonical byte digest of a (possibly nested) state object."""
    h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
    _update(h, obj)
    return h.digest()


def fingerprint_state(obj: Any) -> str:
    """Hex fingerprint of a state object (nested dicts / arrays / scalars)."""
    return canonical_bytes(obj).hex()


def component_fingerprint(component: Any) -> str:
    """Fingerprint of a model or scaler: class + params + fitted state.

    Components expose ``state()`` (fitted arrays) and optionally ``params``
    (hyperparameters); both enter the hash along with the class name, so
    two fits with different data *or* different hyperparameters never
    collide, and an unfitted component has a well-defined fingerprint too.
    """
    return fingerprint_state({
        "class": type(component).__name__,
        "params": getattr(component, "params", {}),
        "state": component.state() if hasattr(component, "state") else {},
    })


def combine_fingerprints(**parts: Any) -> str:
    """One fingerprint over named parts (model/scaler/features/algorithms)."""
    return fingerprint_state({k: v for k, v in sorted(parts.items())})
