"""Port of ``repro/sparse/reorder/__init__.py``: the paper's four label
orderings ``amd``, ``scotch``, ``nd`` and ``rcm`` plus ``natural``, in a plain
dict where the reference uses ``repro.engine.registry``.

Every entry maps ``CSRMatrix -> perm`` with ``perm[new] = old``.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from ..csr import CSRMatrix
from .amd import amd_order
from .hybrid import scotch_order
from .nd import nd_order
from .rcm import rcm_order

__all__ = ["REORDERINGS", "LABEL_ALGORITHMS", "get_reordering",
           "natural_order", "amd_order", "scotch_order", "nd_order",
           "rcm_order"]


def natural_order(a: CSRMatrix) -> np.ndarray:
    return np.arange(a.n, dtype=np.int64)


REORDERINGS: Dict[str, Callable[[CSRMatrix], np.ndarray]] = {
    "natural": natural_order,
    "amd": amd_order,
    "scotch": scotch_order,
    "nd": nd_order,
    "rcm": rcm_order,
}

# The paper's four predictive labels (one per Table 2 category).
LABEL_ALGORITHMS: List[str] = ["amd", "scotch", "nd", "rcm"]


def get_reordering(name: str) -> Callable[[CSRMatrix], np.ndarray]:
    """Resolve a reordering by name; unknown names raise ``KeyError``
    listing the known ones."""
    try:
        return REORDERINGS[name]
    except KeyError:
        raise KeyError(f"unknown reordering {name!r}; known: "
                       f"{sorted(REORDERINGS)}") from None
