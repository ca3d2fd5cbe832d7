"""Port of ``repro/core/labeling.py``: :class:`LabeledDataset` with
``save``/``load`` — the training set of the selector (features, the
argmin-time label per matrix, and the measured times per ordering).

The labeling campaign (``run_labeling_campaign``, ``load_or_build``) needs
``factor_and_solve_timed`` and is not ported yet; a dataset written by the
reference's campaign (``artifacts/labels_*.npz``) loads here as it is.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np

from ..engine.registry import get_feature_set

__all__ = ["LabeledDataset"]


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
