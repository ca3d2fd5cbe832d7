"""Port of ``repro/core/labeling.py``: :class:`LabeledDataset` with
``save``/``load`` — the training set of the selector (features, the
argmin-time label per matrix, and the measured times per ordering) — and
the labeling campaign, ``_measure_one``, ``run_labeling_campaign`` and
``load_or_build`` (:68-144): the paper's §3.2 protocol, which times factor
+ solve per (matrix, ordering) and takes the argmin as the label, with the
multifrontal solver standing in for MUMPS.

As in the reference, the campaign times
:func:`repro_torch.sparse.multifrontal.factor_and_solve_timed` with its
defaults, the host ``numpy`` backend, so labels measure host work. Results
are cached as ``<cache_dir>/labels_<tag>.npz`` with a JSON sidecar, under
the reference's tag and file names, so a cache written by either package
loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..engine.registry import get_feature_set
from ..sparse.csr import CSRMatrix, permute_symmetric
from ..sparse.dataset import generate_suite
from ..sparse.multifrontal import factor_and_solve_timed
from ..sparse.reorder import LABEL_ALGORITHMS, get_reordering

__all__ = ["LabeledDataset", "run_labeling_campaign", "load_or_build"]


@dataclasses.dataclass
class LabeledDataset:
    features: np.ndarray          # (m, 12)
    labels: np.ndarray            # (m,) index into algorithms
    times: np.ndarray             # (m, n_alg) measured factor+solve seconds
    order_times: np.ndarray       # (m, n_alg) ordering computation seconds
    fills: np.ndarray             # (m, n_alg) fill-in of L
    flops: np.ndarray             # (m, n_alg) symbolic factor FLOPs
    names: List[str]
    groups: List[str]
    dims: np.ndarray              # (m,)
    nnzs: np.ndarray              # (m,)
    algorithms: List[str]
    feature_set: str = "paper12"  # registry name of the featurizer used

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(
            path, features=self.features, labels=self.labels,
            times=self.times, order_times=self.order_times, fills=self.fills,
            flops=self.flops, dims=self.dims, nnzs=self.nnzs,
            names=np.array(self.names), groups=np.array(self.groups),
            algorithms=np.array(self.algorithms),
            feature_set=np.array(self.feature_set),
            feature_names=np.array(
                list(get_feature_set(self.feature_set).names)))

    @staticmethod
    def load(path: str) -> "LabeledDataset":
        z = np.load(path, allow_pickle=False)
        return LabeledDataset(
            z["features"], z["labels"], z["times"], z["order_times"],
            z["fills"], z["flops"], [str(s) for s in z["names"]],
            [str(s) for s in z["groups"]], z["dims"], z["nnzs"],
            [str(s) for s in z["algorithms"]],
            # caches written before feature sets carry no feature_set tag
            feature_set=(str(z["feature_set"]) if "feature_set" in z
                         else "paper12"))


def _measure_one(a: CSRMatrix, alg: str, repeats: int) -> Dict:
    """The fastest of ``repeats`` timed factor + solve runs of ``a`` under
    ordering ``alg``, with the ordering's own time as ``t_order``."""
    t0 = time.perf_counter()
    perm = get_reordering(alg)(a)
    t_order = time.perf_counter() - t0
    ap = permute_symmetric(a, perm)
    best: Optional[Dict] = None
    for _ in range(repeats):
        r = factor_and_solve_timed(ap)
        if best is None or r["time"] < best["time"]:
            best = r
    if best is None:
        raise ValueError("repeats must be at least 1")
    best["t_order"] = t_order
    return best


def run_labeling_campaign(
    mats: Sequence[CSRMatrix],
    algorithms: Sequence[str] = tuple(LABEL_ALGORITHMS),
    repeats: int = 1,
    verbose: bool = False,
    feature_set: str = "paper12",
) -> LabeledDataset:
    """Featurize every matrix and time it under every ordering; the label
    is the index of the fastest ordering."""
    fs = get_feature_set(feature_set)
    m = len(mats)
    n_alg = len(algorithms)
    feats = np.zeros((m, fs.dim))
    times = np.zeros((m, n_alg))
    order_times = np.zeros((m, n_alg))
    fills = np.zeros((m, n_alg), dtype=np.int64)
    flops = np.zeros((m, n_alg), dtype=np.int64)
    names, groups = [], []
    dims = np.zeros(m, dtype=np.int64)
    nnzs = np.zeros(m, dtype=np.int64)
    for i, a in enumerate(mats):
        feats[i] = fs.extract(a)
        names.append(a.name)
        groups.append(a.group)
        dims[i], nnzs[i] = a.n, a.nnz
        for j, alg in enumerate(algorithms):
            r = _measure_one(a, alg, repeats)
            times[i, j] = r["time"]
            order_times[i, j] = r["t_order"]
            fills[i, j] = r["fill"]
            flops[i, j] = r["sym_flops"]
        if verbose and (i + 1) % 50 == 0:
            print(f"  labeled {i + 1}/{m}")
    labels = times.argmin(axis=1)
    return LabeledDataset(feats, labels, times, order_times, fills, flops,
                          names, groups, dims, nnzs, list(algorithms),
                          feature_set=feature_set)


def load_or_build(cache_dir: str = "artifacts", count: int = 960,
                  seed: int = 0, size_scale: float = 1.0,
                  repeats: int = 1, verbose: bool = True,
                  feature_set: str = "paper12") -> LabeledDataset:
    """The cached campaign over ``generate_suite(count, seed, size_scale)``,
    run and saved (with a JSON summary beside it) on a miss."""
    tag = f"c{count}_s{seed}_x{size_scale:g}_r{repeats}"
    if feature_set != "paper12":  # paper12 keeps the tag without a suffix
        tag += f"_f{feature_set}"
    path = os.path.join(cache_dir, f"labels_{tag}.npz")
    if os.path.exists(path):
        return LabeledDataset.load(path)
    if verbose:
        print(f"[labeling] building suite ({count} matrices, scale "
              f"{size_scale}) — cached to {path}")
    mats = list(generate_suite(count=count, seed=seed, size_scale=size_scale))
    ds = run_labeling_campaign(mats, repeats=repeats, verbose=verbose,
                               feature_set=feature_set)
    ds.save(path)
    with open(path.replace(".npz", ".json"), "w") as f:
        dist = {alg: int((ds.labels == i).sum())
                for i, alg in enumerate(ds.algorithms)}
        json.dump(dict(count=len(ds.names), label_distribution=dist,
                       n_max=int(ds.dims.max()), nnz_max=int(ds.nnzs.max())),
                  f, indent=2)
    return ds
