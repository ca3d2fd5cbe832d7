"""Copy of ``repro/sparse/reorder/hybrid.py`` (``scotch_order``).

SCOTCH/PORD-style hybrid ordering: nested dissection on top, minimum
degree in the leaves (halo-AMD flavour).

This is the "hybrid algorithms combining fill-in reduction and graph-based
methods" category of the paper's Table 2. Real SCOTCH runs ND until the
subgraphs are small, then switches to (halo-)AMD; we do exactly that with our
own ND and AMD.
"""
from __future__ import annotations

import numpy as np

from ..csr import CSRMatrix
from .amd import amd_order
from .nd import nd_order_with_leaf

__all__ = ["scotch_order"]


def scotch_order(a: CSRMatrix, leaf_size: int = 200) -> np.ndarray:
    return nd_order_with_leaf(a, amd_order, leaf_size=leaf_size)
