"""State carried across from the JAX package as plain data.

:func:`plan_arrays` reads the arrays of any plan with the reference's field
names (``fingerprint``, ``algorithm``, ``perm`` and a ``sym`` with
``parent``, ``counts``, ``Lp``, ``Li``, ``flops``, ``fill``) — a
``repro.core.plan.ExecutionPlan`` as well as this package's — without
importing ``repro``. :func:`plan_from_arrays` builds the port's
:class:`~repro_torch.core.plan.ExecutionPlan` from them, so both packages
can execute the same plan.

:func:`selector_bundle_arrays` reads the fields of a selector bundle — a
``repro.engine.SelectorBundle``, this package's, or any object with their
names — as plain dicts, lists and numpy arrays, and
:func:`bundle_from_arrays` builds the port's validated
:class:`~repro_torch.engine.bundle.SelectorBundle` from them, with the same
fingerprint.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np

from .core.plan import ExecutionPlan
from .engine.bundle import SelectorBundle
from .sparse.symbolic import SymbolicFactor

__all__ = ["plan_arrays", "plan_from_arrays", "selector_bundle_arrays",
           "bundle_from_arrays"]


def plan_arrays(plan) -> dict:
    """The keyword arguments of :func:`plan_from_arrays` for ``plan``."""
    sym = plan.sym
    return dict(fingerprint=plan.fingerprint, algorithm=plan.algorithm,
                perm=np.asarray(plan.perm), parent=np.asarray(sym.parent),
                counts=np.asarray(sym.counts), Lp=np.asarray(sym.Lp),
                Li=np.asarray(sym.Li), flops=int(sym.flops),
                fill=int(sym.fill))


def plan_from_arrays(fingerprint: str, algorithm: str, perm, parent, counts,
                     Lp, Li, flops: int, fill: int) -> ExecutionPlan:
    """The port's plan from the numpy arrays of a plan or symbolic factor
    (``perm[new] = old``; ``Lp``/``Li`` the CSC pattern of L)."""
    sym = SymbolicFactor(np.asarray(parent, dtype=np.int64),
                         np.asarray(counts, dtype=np.int64),
                         np.asarray(Lp, dtype=np.int64),
                         np.asarray(Li, dtype=np.int64), int(flops),
                         int(fill))
    return ExecutionPlan(str(fingerprint), str(algorithm),
                         np.asarray(perm, dtype=np.int64), sym, int(flops))


def selector_bundle_arrays(bundle) -> dict:
    """The keyword arguments of :func:`bundle_from_arrays` for ``bundle``:
    every field of :class:`SelectorBundle`, deep-copied as plain data."""
    return {f.name: copy.deepcopy(getattr(bundle, f.name))
            for f in dataclasses.fields(SelectorBundle)}


def bundle_from_arrays(**fields) -> SelectorBundle:
    """The port's bundle from the fields of a bundle (validated: the
    registry names resolve here, the feature schema matches, and the
    fingerprint recomputes to the stored one)."""
    return SelectorBundle(**fields).validate()
