"""Port of ``repro/kernels/spmv_bell.py``: ``csr_to_bell`` (the reference's
arrays, vectorised), ``pick_spmv_bs`` (the block size that stores the
fewest bytes, new in the port) and ``bell_spmv``, a hand-written CUDA
kernel (``csrc/spmv_bell.cu``) with its plain PyTorch version beside it.

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
from ._build import count_launch, load_kernels

__all__ = ["SPMV_BLOCK_SIZES", "bell_spmv", "bell_spmv_plain", "csr_to_bell",
           "pick_spmv_bs"]


def csr_to_bell(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                n: int, bs: int = 8) -> Tuple[np.ndarray, np.ndarray, int]:
    """Convert CSR to block-ELL: (blocks (R, K, bs, bs), idx (R, K), n_pad).

    The reference's arrays bit for bit, without its loop over blocks: one
    stable sort of the (row-block, col-block) keys, each distinct block's
    slot within its row-block, one scatter. A row-block lists its column
    blocks in increasing order; padding is zero blocks with ``idx`` 0; of
    duplicate entries the last in CSR order wins, as in the reference. CSR
    keeps rows in order, so the stable sort only merges runs (a hash-based
    ``np.unique`` is several times slower on NumPy 2.3)."""
    npad = -(-n // bs) * bs
    nrb = npad // bs
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = np.asarray(indices, dtype=np.int64)
    order = np.argsort(rows // bs * nrb + cols // bs, kind="stable")
    rows, cols = rows[order], cols[order]
    rb, cb = rows // bs, cols // bs
    new = np.ones(order.size, dtype=bool)           # entries opening a block
    new[1:] = (rb[1:] != rb[:-1]) | (cb[1:] != cb[:-1])
    ur = rb[new]
    per_row = np.bincount(ur, minlength=nrb)
    max_k = max(1, int(per_row.max(initial=0)))
    # slot of each distinct block within its row-block, then of each entry
    slot = np.arange(ur.size) - (np.cumsum(per_row) - per_row)[ur]
    blocks = np.zeros((nrb, max_k, bs, bs))
    idx = np.zeros((nrb, max_k), dtype=np.int32)
    idx[ur, slot] = cb[new]
    slot = slot[np.cumsum(new) - 1]
    at = ((rb * max_k + slot) * bs + rows - rb * bs) * bs + cols - cb * bs
    blocks.reshape(-1)[at] = np.asarray(data)[order]
    return blocks, idx, npad


#: the block sizes the residual may take on the card
SPMV_BLOCK_SIZES = (1, 2, 4, 8)


def pick_spmv_bs(indptr: np.ndarray, indices: np.ndarray, n: int) -> int:
    """The block size in :data:`SPMV_BLOCK_SIZES` whose fp64 block-ELL
    layout stores the fewest bytes, nrb · max_k · (bs² · 8 + 4) (blocks
    plus ``idx``), counted from the pattern alone; ties go to the smaller
    bs. The SpMV kernel is bound by those bytes, ELL padding included."""
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    cols = np.asarray(indices, dtype=np.int64)
    best, best_bytes = SPMV_BLOCK_SIZES[0], None
    for bs in SPMV_BLOCK_SIZES:
        nrb = -(-n // bs)
        keys = np.sort(rows // bs * nrb + cols // bs, kind="stable")
        first = np.ones(keys.size, dtype=bool)
        first[1:] = keys[1:] != keys[:-1]
        per_row = np.bincount(keys[first] // nrb, minlength=nrb)
        nbytes = nrb * max(1, int(per_row.max(initial=0))) * (bs * bs * 8 + 4)
        if best_bytes is None or nbytes < best_bytes:
            best, best_bytes = bs, nbytes
    return best


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
        count_launch(bell_spmv)
    else:
        y = bell_spmv_plain(blocks, idx, x2)
    return y[:, 0] if single else y


bell_spmv.launches = 0
