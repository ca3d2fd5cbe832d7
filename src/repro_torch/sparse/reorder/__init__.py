"""Port of ``repro/sparse/reorder/__init__.py``: the paper's four label
orderings ``amd``, ``scotch``, ``nd`` and ``rcm`` plus ``natural``,
registered in :data:`repro_torch.engine.registry.REORDERING_REGISTRY` with
their Table-2 category as metadata. ``REORDERINGS`` is that registry (a
``Mapping``).

Every entry maps ``CSRMatrix -> perm`` with ``perm[new] = old``.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np

from ...engine.registry import REORDERING_REGISTRY, register_reordering
from ..csr import CSRMatrix
from .amd import amd_order
from .hybrid import scotch_order
from .nd import nd_order
from .rcm import rcm_order

__all__ = ["REORDERINGS", "LABEL_ALGORITHMS", "get_reordering",
           "natural_order", "amd_order", "scotch_order", "nd_order",
           "rcm_order"]


@register_reordering("natural", category="identity")
def natural_order(a: CSRMatrix) -> np.ndarray:
    return np.arange(a.n, dtype=np.int64)


for _name, _fn, _cat in [
    ("rcm", rcm_order, "bandwidth-reduction"),
    ("amd", amd_order, "fill-in-reduction"),
    ("nd", nd_order, "graph-based"),
    ("scotch", scotch_order, "hybrid"),
]:
    register_reordering(_name, category=_cat)(_fn)
del _name, _fn, _cat

REORDERINGS = REORDERING_REGISTRY

# The paper's four predictive labels (one per Table 2 category).
LABEL_ALGORITHMS: List[str] = ["amd", "scotch", "nd", "rcm"]


def get_reordering(name: str) -> Callable[[CSRMatrix], np.ndarray]:
    """Resolve a reordering by name; unknown names raise
    :class:`~repro_torch.engine.registry.RegistryLookupError` (a
    ``KeyError``) listing the known ones, with suggestions."""
    return REORDERING_REGISTRY[name]
