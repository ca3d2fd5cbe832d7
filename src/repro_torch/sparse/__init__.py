"""Sparse direct-solver substrate of the port: containers, reordering
algorithms, symbolic analysis, numeric solvers (simplicial, multifrontal)
and the synthetic Florida-like matrix suite."""
from .csr import (CSRMatrix, bandwidth, coo_to_csr, csr_from_dense, make_spd,
                  permute_symmetric, profile, symmetrize_pattern)
from .refine import RefineInfo, refine_solve
from .reorder import LABEL_ALGORITHMS, REORDERINGS, get_reordering
from .schedule import LevelSchedule, build_schedule
from .symbolic import (SymbolicFactor, cholesky_flops, column_counts, etree,
                       fill_in, postorder, supernodes, symbolic_cholesky)

__all__ = [
    "CSRMatrix", "bandwidth", "coo_to_csr", "csr_from_dense", "make_spd",
    "permute_symmetric", "profile", "symmetrize_pattern",
    "LABEL_ALGORITHMS", "REORDERINGS", "get_reordering",
    "SymbolicFactor", "cholesky_flops", "column_counts", "etree", "fill_in",
    "postorder", "supernodes", "symbolic_cholesky",
    "LevelSchedule", "build_schedule", "RefineInfo", "refine_solve",
]
