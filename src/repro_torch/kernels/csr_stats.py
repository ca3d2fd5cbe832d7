"""Port of ``repro/kernels/csr_stats.py``: ``entry_stats`` and
``row_stats``, the featurizer's per-matrix reductions over a padded CSR
batch, as hand-written CUDA kernels (``csrc/csr_stats.cu``) with their plain
PyTorch versions beside them.

``entry_stats`` gives bandwidth (max |r − c| over valid entries) and
profile (Σ (r − c) over first-of-row entries with c < r) of every matrix of
a ``(B, E)`` entry batch; ``row_stats`` gives max, min and Σ (cnt − mean)²
of the valid rows' counts of a ``(B, N)`` row batch. Same signatures and
results as the reference. The plain versions are the reference's
reductions without Pallas (``repro/core/features.py:295-304``), with the
Pallas kernel's min identity (3.4e38) for a matrix with no valid row.

The wrappers take the plain version only for CPU tensors; for CUDA tensors
they launch the kernel or raise, and count their launches in
``.launches``. The kernel reads int32: the wrappers never convert, so an
int64 index reaching them raises.
"""
from __future__ import annotations

import torch

from ..device import on_cuda
from ._build import count_launch, load_kernels

__all__ = ["entry_stats", "row_stats", "entry_stats_plain", "row_stats_plain",
           "CHUNK", "ROW_CHUNK", "ROW_MIN_INIT"]

#: entries one entry_stats block reduces
CHUNK = 4096
#: rows one row_stats block reduces (a multiple of 4: it reads 16 bytes at a
#: time)
ROW_CHUNK = 8192
#: min-accumulator identity (~f32 max), the reference's ``_ROW_MIN_INIT``
ROW_MIN_INIT = 3.4e38


def entry_stats_plain(rows: torch.Tensor, cols: torch.Tensor,
                      valid: torch.Tensor, first: torch.Tensor
                      ) -> torch.Tensor:
    """Plain version of :func:`entry_stats`: bandwidth as an integer max,
    profile summed in float32 (as the reference sums it)."""
    d = rows - cols
    bw = torch.where(valid != 0, d.abs(), 0).amax(dim=1).to(torch.float32)
    prof = torch.where((first != 0) & (d > 0), d, 0).to(torch.float32).sum(
        dim=1)
    return torch.stack([bw, prof], dim=1)


def row_stats_plain(row_nnz: torch.Tensor, row_valid: torch.Tensor,
                    mean: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`row_stats`, in float32."""
    valid = row_valid != 0
    cnt = row_nnz.to(torch.float32)
    mx = torch.where(valid, cnt, 0.0).amax(dim=1)
    mn = torch.where(valid, cnt, ROW_MIN_INIT).amin(dim=1)
    sq = torch.where(valid, (cnt - mean[:, None]) ** 2, 0.0).sum(dim=1)
    return torch.stack([mx, mn, sq], dim=1)


def entry_stats(rows: torch.Tensor, cols: torch.Tensor, valid: torch.Tensor,
                first: torch.Tensor) -> torch.Tensor:
    """Per-matrix [bandwidth, profile] over a padded entry batch.

    rows/cols: (B, E) int32; valid/first: (B, E) int32 masks (0/1).
    Returns (B, 2) float32.
    """
    if not on_cuda(rows, cols, valid, first):
        return entry_stats_plain(rows, cols, valid, first)
    B, E = rows.shape
    parts = (B, -(-E // CHUNK))
    bw_part = torch.empty(parts, dtype=torch.int32, device=rows.device)
    prof_part = torch.empty(parts, dtype=torch.int64, device=rows.device)
    out = torch.empty((B, 2), dtype=torch.float32, device=rows.device)
    load_kernels().entry_stats(rows, cols, valid, first, CHUNK, bw_part,
                               prof_part, out)
    count_launch(entry_stats)
    return out


#: per (device, stream): int32 arrival counters of ``row_stats``, all zero
#: between calls (the kernel's last block of a matrix resets its counter)
_ARRIVED: dict = {}


def _arrival_counters(device: torch.device, B: int) -> torch.Tensor:
    """At least B zeroed counters for ``row_stats`` on the current stream
    of ``device``. Calls on one stream run in order, so they can share
    them."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    cnt = _ARRIVED.get(key)
    if cnt is None or cnt.numel() < B:
        cnt = _ARRIVED[key] = torch.zeros(max(B, 64), dtype=torch.int32,
                                          device=device)
    return cnt


def row_stats(row_nnz: torch.Tensor, row_valid: torch.Tensor,
              mean: torch.Tensor) -> torch.Tensor:
    """Per-matrix [max, min, Σ(x−mean)²] of valid per-row nonzero counts.

    row_nnz/row_valid: (B, N) int32; mean: (B,) float32 (= nnz/n, computed
    by the caller so the deviation sum is single-pass).
    Returns (B, 3) float32. One kernel launch.
    """
    if not on_cuda(row_nnz, row_valid, mean):
        return row_stats_plain(row_nnz, row_valid, mean)
    B, N = row_nnz.shape
    dev = row_nnz.device
    parts = (B, max(1, -(-N // ROW_CHUNK)))
    mx_part = torch.empty(parts, dtype=torch.int32, device=dev)
    mn_part = torch.empty(parts, dtype=torch.int32, device=dev)
    sq_part = torch.empty(parts, dtype=torch.float64, device=dev)
    out = torch.empty((B, 3), dtype=torch.float32, device=dev)
    load_kernels().row_stats(row_nnz, row_valid, mean, ROW_CHUNK, mx_part,
                             mn_part, sq_part, _arrival_counters(dev, B), out)
    count_launch(row_stats)
    return out


entry_stats.launches = 0
row_stats.launches = 0
