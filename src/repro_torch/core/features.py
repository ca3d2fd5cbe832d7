"""Port of ``repro/core/features.py``: the paper's 12 matrix features
(Table 3), on the host and on the card.

| feature    | description                      |
|------------|----------------------------------|
| dimension  | number of rows (square matrix)   |
| nnz        | number of nonzeros               |
| nnz_ratio  | nnz / n²                         |
| nnz_max    | max nonzeros per row             |
| nnz_min    | min nonzeros per row             |
| nnz_avg    | mean nonzeros per row            |
| nnz_std    | std of nonzeros per row          |
| degree_max | max node degree (symmetrized graph, no diagonal) |
| degree_min | min node degree                  |
| degree_avg | mean node degree                 |
| bandwidth  | max |i−j| over nonzeros (Eq. 2)  |
| profile    | Σᵢ (i − min{j : aᵢⱼ≠0}) (Eq. 3)  |

Copied: ``FEATURE_NAMES``, ``EXTENDED_FEATURE_NAMES``, the host paths
``extract_features`` / ``extract_features_batch`` /
``extract_features_extended``, ``CSRBatch`` and ``pad_csr_batch`` (:138).
Ported: ``_extract_features_batch_impl`` (:252-339) as
:func:`extract_features_batch_device`, the serving featurizer on tensors:
CSR-native over a padded ``(indptr, indices)`` batch, never a dense
``(n, n)`` array. Its five reductions always go through the
``entry_stats`` / ``row_stats`` CUDA kernels
(:mod:`repro_torch.kernels.csr_stats`), where the reference calls its
Pallas kernels with ``use_pallas=True``; the reference's ``use_pallas``
switch is not ported, since its other branch would run the plain
reductions on the card. The legacy dense
``extract_features_jnp`` is not ported. ``paper12`` (with the device
extractor) and ``extended19`` (host only) register as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device, to_device
from ..engine.registry import register_feature_set
from ..kernels.csr_stats import entry_stats, row_stats
from ..sparse.csr import CSRMatrix, bandwidth, profile
from ..sparse.graph import adjacency, degrees

__all__ = ["FEATURE_NAMES", "EXTENDED_FEATURE_NAMES", "extract_features",
           "extract_features_batch", "extract_features_extended",
           "CSRBatch", "pad_csr_batch", "extract_features_batch_device",
           "csr_stats_args"]

FEATURE_NAMES = [
    "dimension", "nnz", "nnz_ratio", "nnz_max", "nnz_min", "nnz_avg",
    "nnz_std", "degree_max", "degree_min", "degree_avg", "bandwidth",
    "profile",
]

# Beyond-paper feature set: normalized/shape-aware derivatives that separate
# "banded" from "scale-free" structure far better than the raw Table-3
# features.
EXTENDED_FEATURE_NAMES = FEATURE_NAMES + [
    "bandwidth_ratio",     # bandwidth / n
    "profile_ratio",       # profile / (n · bandwidth)
    "degree_std",          # spread of the degree distribution
    "degree_skew",         # hub indicator (scale-free vs mesh)
    "mean_absdist",        # mean |i−j| over nonzeros (band localization)
    "diag_dominance",      # fraction of nonzeros on ±1% band
    "row_nnz_cv",          # coefficient of variation of row counts
]


def extract_features(a: CSRMatrix) -> np.ndarray:
    n = a.n
    row_nnz = a.row_lengths().astype(np.float64)
    adj = adjacency(a)
    deg = degrees(adj).astype(np.float64)
    nnz = float(a.nnz)
    feats = np.array([
        float(n),
        nnz,
        nnz / float(n) ** 2,
        float(row_nnz.max()) if n else 0.0,
        float(row_nnz.min()) if n else 0.0,
        float(row_nnz.mean()) if n else 0.0,
        float(row_nnz.std()) if n else 0.0,
        float(deg.max()) if n else 0.0,
        float(deg.min()) if n else 0.0,
        float(deg.mean()) if n else 0.0,
        float(bandwidth(a)),
        float(profile(a)),
    ], dtype=np.float64)
    return feats


def extract_features_batch(mats) -> np.ndarray:
    return np.stack([extract_features(m) for m in mats])


def extract_features_extended(a: CSRMatrix) -> np.ndarray:
    """Paper features + 7 beyond-paper structure descriptors."""
    base = extract_features(a)
    n = max(a.n, 1)
    bw = max(base[FEATURE_NAMES.index("bandwidth")], 1.0)
    prof = base[FEATURE_NAMES.index("profile")]
    row_nnz = a.row_lengths().astype(np.float64)
    adj = adjacency(a)
    deg = degrees(adj).astype(np.float64)
    dstd = float(deg.std())
    skew = (float(((deg - deg.mean()) ** 3).mean()) / max(dstd, 1e-12) ** 3
            if dstd > 0 else 0.0)
    rows = np.repeat(np.arange(a.n, dtype=np.int64), a.row_lengths())
    absdist = np.abs(rows - a.indices.astype(np.int64))
    near = float((absdist <= max(1, n // 100)).mean()) if a.nnz else 1.0
    ext = np.array([
        bw / n,
        prof / (n * bw),
        dstd,
        skew,
        float(absdist.mean()) if a.nnz else 0.0,
        near,
        float(row_nnz.std() / max(row_nnz.mean(), 1e-12)),
    ], dtype=np.float64)
    return np.concatenate([base, ext])


class CSRBatch(NamedTuple):
    """Padded batch of CSR patterns — the wire format of the serving path.

    indptr:  (B, N+1) int32, rows past n[b] padded with nnz[b]
    indices: (B, E)   int32, entries past nnz[b] padded with 0
    n:       (B,)     int32 true dimensions
    nnz:     (B,)     int32 true nonzero counts
    """

    indptr: np.ndarray
    indices: np.ndarray
    n: np.ndarray
    nnz: np.ndarray


def _next_pow2(x: int) -> int:
    return 1 << max(3, (x - 1).bit_length())


def pad_csr_batch(mats: Sequence[CSRMatrix], n_max: Optional[int] = None,
                  nnz_max: Optional[int] = None,
                  bucket: bool = False) -> CSRBatch:
    """Pack matrices of ragged sizes into one padded CSR buffer batch.

    ``bucket=True`` rounds the padded dims up to powers of two so a stream
    of similarly-sized batches hits a handful of shape buckets (the serving
    path uses this).
    """
    assert len(mats) > 0
    nmax = max(m.n for m in mats) if n_max is None else n_max
    emax = max(max(m.nnz for m in mats), 1) if nnz_max is None else nnz_max
    if bucket:
        nmax, emax = _next_pow2(nmax), _next_pow2(emax)
    b = len(mats)
    indptr = np.zeros((b, nmax + 1), np.int32)
    indices = np.zeros((b, emax), np.int32)
    n = np.zeros(b, np.int32)
    nnz = np.zeros(b, np.int32)
    for i, m in enumerate(mats):
        indptr[i, : m.n + 1] = m.indptr
        indptr[i, m.n + 1 :] = m.nnz
        indices[i, : m.nnz] = m.indices
        n[i], nnz[i] = m.n, m.nnz
    return CSRBatch(indptr, indices, n, nnz)


class _Entries(NamedTuple):
    """Per-entry and per-row tensors of an uploaded batch (int32 where the
    reference's wire format is int32; masks as bool)."""

    indptr: torch.Tensor     # (B, N+1)
    indices: torch.Tensor    # (B, E)
    n: torch.Tensor          # (B,)
    nnz: torch.Tensor        # (B,)
    rows: torch.Tensor       # (B, E) row id of every entry
    cols: torch.Tensor       # (B, E) column id, clipped to the padded dim
    valid: torch.Tensor      # (B, E) entry < nnz[b]
    isfirst: torch.Tensor    # (B, E) entry starts its row
    row_nnz: torch.Tensor    # (B, N)
    row_valid: torch.Tensor  # (B, N) row < n[b]
    nnz_avg: torch.Tensor    # (B,) f32 nnz / max(n, 1)


def _entries(batch: CSRBatch, dev: torch.device) -> _Entries:
    indptr = to_device(np.asarray(batch.indptr, np.int32), dev)
    indices = to_device(np.asarray(batch.indices, np.int32), dev)
    n = to_device(np.asarray(batch.n, np.int32), dev)
    nnz = to_device(np.asarray(batch.nnz, np.int32), dev)
    bsz, e = indices.shape
    nmax = indptr.shape[1] - 1
    entry_ids = torch.arange(e, dtype=torch.int32, device=dev)
    valid = entry_ids[None, :] < nnz[:, None]
    # row id of entry k: the i with indptr[i] <= k < indptr[i+1]
    rows = torch.searchsorted(indptr, entry_ids.expand(bsz, e).contiguous(),
                              right=True, out_int32=True)
    rows = (rows - 1).clamp_(0, nmax - 1)
    cols = indices.clamp(0, nmax - 1)
    # first-entry-of-row mask: entry k starts its row iff indptr[rows[k]] == k
    row_start = torch.gather(indptr, 1, rows.long())
    isfirst = valid & (row_start == entry_ids[None, :])
    row_valid = (torch.arange(nmax, dtype=torch.int32, device=dev)[None, :]
                 < n[:, None])
    row_nnz = indptr[:, 1:] - indptr[:, :-1]
    nnz_avg = nnz.to(torch.float32) / n.to(torch.float32).clamp(min=1.0)
    return _Entries(indptr, indices, n, nnz, rows, cols, valid, isfirst,
                    row_nnz, row_valid, nnz_avg)


def _stats_args(t: _Entries) -> tuple:
    """``((rows, cols, valid, first), (row_nnz, row_valid, mean))``: the
    int32 / float32 arguments of ``entry_stats`` and ``row_stats``."""
    return ((t.rows, t.cols, t.valid.to(torch.int32),
             t.isfirst.to(torch.int32)),
            (t.row_nnz, t.row_valid.to(torch.int32), t.nnz_avg))


def csr_stats_args(batch: CSRBatch, device=None) -> tuple:
    """The arguments :func:`extract_features_batch_device` hands
    ``entry_stats`` and ``row_stats`` for ``batch``, on ``device``:
    ``((rows, cols, valid, first), (row_nnz, row_valid, mean))``."""
    return _stats_args(_entries(batch, resolve_device(device)))


def extract_features_batch_device(batch: CSRBatch, *, device=None) -> torch.Tensor:
    """All 12 Table-3 features for a padded CSR batch, on ``device``
    (``None`` → CUDA, raising when there is none; ``"cpu"`` runs the
    kernels' plain versions).

    Pure segment reductions over ``(indptr, indices)``: per-entry row ids by
    binary search on indptr, degrees of the symmetrized graph by float32
    scatter-add (exact: the values are integer counts below 2^24) and a
    reciprocal-edge membership search over the sorted row segments with the
    reference's static trip count, and bandwidth/profile/row statistics as
    flat masked reductions. Memory is O(B·(N+E)).

    The two entry reductions and three row reductions go through the
    ``entry_stats`` / ``row_stats`` wrappers, where the reference calls its
    Pallas kernels: on a CUDA device they launch the kernels, on the CPU
    they run their plain versions.
    Returns a ``(B, 12)`` float32 tensor on ``device``, ordered like
    ``FEATURE_NAMES``.
    """
    dev = resolve_device(device)
    t = _entries(batch, dev)
    rows, cols, valid, n = t.rows, t.cols, t.valid, t.n
    bsz, e = t.indices.shape
    nmax = t.indptr.shape[1] - 1
    nf = n.to(torch.float32)
    nnzf = t.nnz.to(torch.float32)
    entry_args, row_args = _stats_args(t)
    es = entry_stats(*entry_args)
    rs = row_stats(*row_args)
    bw, prof = es[:, 0], es[:, 1]
    nnz_max, nnz_sq = rs[:, 0], rs[:, 2]
    nnz_min = torch.where(n > 0, rs[:, 1], 0.0)
    nnz_std = torch.sqrt(nnz_sq / nf.clamp(min=1.0))

    # degrees of the symmetrized off-diagonal graph, CSR-native:
    # deg_i = outdeg_i + indeg_i − #reciprocated edges of row i
    offdiag = valid & (rows != cols)
    w = offdiag.to(torch.float32)
    rows_l, cols_l = rows.long(), cols.long()
    zeros = torch.zeros((bsz, nmax), dtype=torch.float32, device=dev)
    outdeg = zeros.scatter_add(1, rows_l, w)
    indeg = zeros.scatter_add(1, cols_l, w)
    # reciprocal membership: binary-search row cols[k] for value rows[k]
    # (column segments are sorted) — lower_bound with a static trip count
    lo = torch.gather(t.indptr, 1, cols_l)
    hi0 = torch.gather(t.indptr, 1, cols_l + 1)
    hi = hi0
    for _ in range(max(1, int(np.ceil(np.log2(e + 1))) + 1)):
        mid = (lo + hi) // 2
        midv = torch.gather(t.indices, 1, mid.clamp(0, e - 1).long())
        active = lo < hi
        go_right = active & (midv < rows)
        hi = torch.where(active & ~go_right, mid, hi)
        lo = torch.where(go_right, mid + 1, lo)
    atlo = torch.gather(t.indices, 1, lo.clamp(0, e - 1).long())
    recip_flag = offdiag & (lo < hi0) & (atlo == rows)
    recip = zeros.scatter_add(1, rows_l, recip_flag.to(torch.float32))
    deg = outdeg + indeg - recip
    row_valid = t.row_valid
    deg_max = torch.where(row_valid, deg, 0.0).amax(dim=1)
    deg_min = torch.where(row_valid, deg, float("inf")).amin(dim=1)
    deg_min = torch.where(n > 0, deg_min, 0.0)
    deg_avg = (torch.where(row_valid, deg, 0.0).sum(dim=1)
               / nf.clamp(min=1.0))

    return torch.stack([
        nf, nnzf, nnzf / nf.clamp(min=1.0) ** 2,
        nnz_max, nnz_min, t.nnz_avg, nnz_std,
        deg_max, deg_min, deg_avg, bw, prof,
    ], dim=1)


# ---------------------------------------------------------------------------
# Feature-set registration — the engine resolves featurizers by name; the
# schema (name list) is persisted in SelectorBundles and validated on load.
# ---------------------------------------------------------------------------

register_feature_set("paper12", names=FEATURE_NAMES,
                     extract=extract_features,
                     extract_batch=extract_features_batch,
                     extract_batch_device=extract_features_batch_device,
                     paper="Table 3")
register_feature_set("extended19", names=EXTENDED_FEATURE_NAMES,
                     extract=extract_features_extended,
                     paper="Table 3 + beyond-paper feature study")
