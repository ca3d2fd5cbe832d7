"""Port of ``repro/kernels/spmv_bell.py``: ``csr_to_bell`` (host copy) and
``bell_spmv``, a hand-written CUDA kernel (``csrc/spmv_bell.cu``) with its
plain PyTorch version beside it.

The matrix is stored as dense (bs×bs) blocks in an ELL layout: every
block-row holds exactly ``max_k`` blocks (zero-padded) and ``idx`` names each
block's column block. The refinement loop uses it over fp64 blocks for the
residual ``b − A x``. The wrapper takes the plain version only for CPU
tensors; for CUDA tensors it launches the kernel or raises, and counts its
launches in ``bell_spmv.launches``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import on_cuda
from ._build import load_kernels

__all__ = ["bell_spmv", "bell_spmv_plain", "csr_to_bell"]


def csr_to_bell(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                n: int, bs: int = 8) -> Tuple[np.ndarray, np.ndarray, int]:
    """Convert CSR to block-ELL: (blocks (R, K, bs, bs), idx (R, K), n_pad)."""
    npad = ((n + bs - 1) // bs) * bs
    nrb = npad // bs
    # bucket nonzeros into (row_block, col_block)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    rb, cb = rows // bs, indices // bs
    keys = rb * nrb + cb
    order = np.argsort(keys, kind="stable")
    rows_s, cols_s, data_s, keys_s = rows[order], indices[order], data[order], keys[order]
    uniq, starts = np.unique(keys_s, return_index=True)
    starts = np.append(starts, keys_s.size)
    per_row: list[list[tuple[int, np.ndarray]]] = [[] for _ in range(nrb)]
    for u, s0, s1 in zip(uniq, starts[:-1], starts[1:]):
        r, c = int(u) // nrb, int(u) % nrb
        blk = np.zeros((bs, bs))
        blk[rows_s[s0:s1] - r * bs, cols_s[s0:s1] - c * bs] = data_s[s0:s1]
        per_row[r].append((c, blk))
    max_k = max(1, max(len(p) for p in per_row))
    blocks = np.zeros((nrb, max_k, bs, bs))
    idx = np.zeros((nrb, max_k), dtype=np.int32)
    for r, plist in enumerate(per_row):
        for k, (c, blk) in enumerate(plist):
            blocks[r, k] = blk
            idx[r, k] = c
    return blocks, idx, npad


def bell_spmv_plain(blocks: torch.Tensor, idx: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Plain version: gather each block's x rows and contract, in the
    element type of ``blocks``. ``x`` is (n_pad, k)."""
    nrb, max_k, bs, _ = blocks.shape
    xb = x.reshape(nrb, bs, -1)[idx.long()]             # (nrb, max_k, bs, k)
    return torch.einsum("rkij,rkjc->ric", blocks, xb).reshape(nrb * bs, -1)


def bell_spmv(blocks: torch.Tensor, idx: torch.Tensor, x: torch.Tensor
              ) -> torch.Tensor:
    """y = A @ x with A in block-ELL form (``blocks`` (nrb, max_k, bs, bs),
    ``idx`` (nrb, max_k) int32). ``x``: ``(n_pad,)`` or an RHS block
    ``(n_pad, k)`` of the blocks' dtype (float64 or float32); the result
    has x's shape and dtype and is summed in that dtype."""
    if x.dtype != blocks.dtype:
        raise TypeError(f"x is {x.dtype}, blocks are {blocks.dtype}")
    single = x.dim() == 1
    x2 = x[:, None] if single else x
    if on_cuda(blocks, idx, x):
        x2 = x2.contiguous()
        y = torch.empty_like(x2)
        load_kernels().bell_spmv(blocks, idx, x2, y)
        bell_spmv.launches += 1
    else:
        y = bell_spmv_plain(blocks, idx, x2)
    return y[:, 0] if single else y


bell_spmv.launches = 0
