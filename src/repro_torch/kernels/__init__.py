"""Hand-written CUDA kernels of the port (``csrc/``) and their wrappers.

:data:`KERNELS` names each kernel's wrapper; every wrapper counts the
kernel calls it makes on CUDA tensors in its ``launches`` attribute.
"""
from __future__ import annotations

from typing import Dict

from ._build import reset_launches
from .csr_stats import entry_stats, row_stats
from .flash_attention import flash_attention, flash_attention_bwd
from .frontal_cholesky import (chol_tile, extend_add_batch,
                               frontal_factor_batch, matmul_nt, tri_inv_tile,
                               tri_solve_batch)
from .spmv_bell import bell_spmv

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts"]

KERNELS = {
    "frontal_factor_batch": frontal_factor_batch,
    "extend_add_batch": extend_add_batch,
    "tri_solve_batch": tri_solve_batch,
    "bell_spmv": bell_spmv,
    "entry_stats": entry_stats,
    "row_stats": row_stats,
    "chol_tile": chol_tile,
    "tri_inv_tile": tri_inv_tile,
    "matmul_nt": matmul_nt,
    "flash_attention": flash_attention,
    "flash_attention_bwd": flash_attention_bwd,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    reset_launches(KERNELS.values())
