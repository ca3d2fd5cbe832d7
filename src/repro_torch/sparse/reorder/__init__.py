"""Port of ``repro/sparse/reorder/__init__.py``.

The seven algorithms of the paper's Table 2 plus the natural (identity)
ordering, registered in :data:`repro_torch.engine.registry.REORDERING_REGISTRY`
with their Table-2 category as metadata. The four *label* algorithms used by
the selector are ``rcm``, ``amd``, ``nd``, ``scotch`` (one per category, as in
the paper).

Every entry maps ``CSRMatrix -> perm`` with ``perm[new] = old``.
``REORDERINGS`` is the registry itself (``Mapping``-compatible); third-party
orderings plug in with::

    from repro_torch.engine import register_reordering

    @register_reordering("my_order", category="fill-in-reduction")
    def my_order(a): ...
"""
from __future__ import annotations

from typing import Callable, List, Mapping

import numpy as np

from ...engine.registry import REORDERING_REGISTRY, register_reordering
from ..csr import CSRMatrix
from .amd import amd_order, amf_order, md_order, qamd_order
from .hybrid import scotch_order
from .nd import nd_order
from .rcm import cm_order, rcm_order

__all__ = [
    "REORDERINGS",
    "REORDERING_REGISTRY",
    "register_reordering",
    "LABEL_ALGORITHMS",
    "CATEGORY_OF",
    "get_reordering",
    "natural_order",
    "cm_order", "rcm_order", "md_order", "amd_order", "qamd_order",
    "amf_order", "nd_order", "scotch_order",
]


@register_reordering("natural", category="identity")
def natural_order(a: CSRMatrix) -> np.ndarray:
    return np.arange(a.n, dtype=np.int64)


for _name, _fn, _cat in [
    ("cm", cm_order, "bandwidth-reduction"),
    ("rcm", rcm_order, "bandwidth-reduction"),
    ("md", md_order, "fill-in-reduction"),
    ("amd", amd_order, "fill-in-reduction"),
    ("qamd", qamd_order, "fill-in-reduction"),
    ("amf", amf_order, "fill-in-reduction"),
    ("nd", nd_order, "graph-based"),
    ("scotch", scotch_order, "hybrid"),
]:
    register_reordering(_name, category=_cat)(_fn)
del _name, _fn, _cat

REORDERINGS = REORDERING_REGISTRY

# The paper's four predictive labels (one per Table 2 category).
LABEL_ALGORITHMS: List[str] = ["amd", "scotch", "nd", "rcm"]


class _CategoryView(Mapping):
    """Live Table-2 category view over the registry metadata
    (late-registered orderings appear here too)."""

    def __getitem__(self, name):
        return REORDERING_REGISTRY.metadata(name).get("category",
                                                      "uncategorized")

    def __iter__(self):
        return iter(REORDERING_REGISTRY)

    def __len__(self):
        return len(REORDERING_REGISTRY)


CATEGORY_OF = _CategoryView()


def get_reordering(name: str) -> Callable[[CSRMatrix], np.ndarray]:
    """Resolve a reordering by name; unknown names raise
    :class:`~repro_torch.engine.registry.RegistryLookupError` (a
    ``KeyError``) listing the known ones, with suggestions."""
    return REORDERING_REGISTRY[name]
