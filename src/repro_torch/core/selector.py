"""Port of ``repro/core/selector.py``: the reordering-algorithm selector —
the paper's deliverable.

``ReorderSelector`` = feature extraction → scaler → classifier → algorithm
name. ``select`` runs the trained pipeline on one matrix on the host;
``select_batch`` is the serving path over many matrices at once,
through the host featurizer or the CSR-native device featurizer
(:func:`repro_torch.core.features.extract_features_batch_device`). On the
device path the scaler transform, the classifier's forward (the forest
traversal, or the products of logistic regression, SVM and MLP) and the
argmax run on the card too (``_predict_device``); the feature batch never
leaves it, only the label indices do. There is one card and no serving
mesh, so the reference's shard_map and padding to the mesh width have no
counterpart. A model without ``forward_device`` (KNN, naive Bayes)
classifies on the host.

``train_selector`` grid-searches and refits a selector on a
:class:`~repro_torch.core.labeling.LabeledDataset`, as the reference does.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.registry import FeatureSet, get_feature_set
from ..sparse.csr import CSRMatrix
from .features import pad_csr_batch
from .labeling import LabeledDataset
from .ml import MODEL_ZOO, BaseClassifier, accuracy_score
from .model_selection import GridSearchCV, train_test_split
from .scaling import SCALERS, scaler_transform_device

__all__ = ["ReorderSelector", "DEFAULT_GRIDS", "FAST_GRIDS",
           "train_selector"]


# Hyperparameter grids per model family (paper §3.4: "candidate values are
# usually given by empirical methods").
DEFAULT_GRIDS: Dict[str, Dict[str, Sequence]] = {
    "random_forest": {
        "criterion": ["gini"],
        "min_samples_leaf": [1, 2],
        "min_samples_split": [2, 5],
        "n_estimators": [50, 100],
    },
    "decision_tree": {
        "criterion": ["gini", "entropy"],
        "max_depth": [None, 8, 16],
        "min_samples_leaf": [1, 2, 5],
    },
    "logistic_regression": {"C": [0.1, 1.0, 10.0], "steps": [500]},
    "naive_bayes": {"var_smoothing": [1e-9, 1e-6]},
    "svm": {"C": [1.0, 10.0], "gamma": [0.1, 0.5], "kernel": ["rbf"]},
    "mlp": {"hidden_layer_sizes": [(64, 32), (128,)], "lr": [0.01]},
    "knn": {"n_neighbors": [3, 5, 9], "weights": ["uniform", "distance"]},
}

# Smaller grids for smoke-speed runs.
FAST_GRIDS: Dict[str, Dict[str, Sequence]] = {
    k: {p: v[:1] for p, v in g.items()} for k, g in DEFAULT_GRIDS.items()
}


class ReorderSelector:
    def __init__(self, model: BaseClassifier, scaler, algorithms: List[str],
                 feature_set: str = "paper12"):
        self.model = model
        self.scaler = scaler
        self.algorithms = algorithms
        # registry name of the feature schema this selector was trained on
        # (resolved lazily; bundles persist and validate it)
        self.feature_set = feature_set

    def _fs(self) -> FeatureSet:
        return get_feature_set(self.feature_set)

    # -- inference -----------------------------------------------------------
    def predict_features(self, feats: np.ndarray) -> np.ndarray:
        feats = np.atleast_2d(feats)
        return self.model.predict(self.scaler.transform(feats))

    def select(self, a: CSRMatrix) -> Tuple[str, float]:
        """Returns (algorithm name, prediction seconds) — Table 5's columns."""
        t0 = time.perf_counter()
        feats = self._fs().extract(a)
        idx = int(self.predict_features(feats)[0])
        return self.algorithms[idx], time.perf_counter() - t0

    # -- batched serving path --------------------------------------------------
    def select_batch(self, mats: Sequence[CSRMatrix], *, path: str = "host",
                     device=None) -> Tuple[List[str], float]:
        """Select for a whole batch at once; returns (names, total seconds).

        ``path='host'`` runs the per-matrix numpy featurizer; ``'device'``
        packs the batch into padded CSR buffers (``bucket=True``) and runs
        the segment-reduction featurizer on ``device`` (``None`` → CUDA;
        on a card through the ``csr_stats`` kernels), then classifies
        there. The seconds end after the label indices reach the
        host.
        """
        assert path in ("host", "device"), path
        t0 = time.perf_counter()
        fs = self._fs()
        if path == "device" and fs.extract_batch_device is not None:
            feats = fs.extract_batch_device(
                pad_csr_batch(mats, bucket=True), device=device)
            idx = self._predict_device(feats)
        else:  # host path, or a feature set with no device extractor
            idx = self.predict_features(fs.batch(mats))
        names = [self.algorithms[int(i)] for i in idx]
        return names, time.perf_counter() - t0

    def _predict_device(self, feats: torch.Tensor) -> np.ndarray:
        """Label indices for a (B, d) float32 feature tensor.

        Models exposing ``forward_device`` (trees and forests, via
        :mod:`repro_torch.core.ml.forest_torch`, and the models of
        :mod:`repro_torch.core.ml.torch_models`) classify on the tensor's
        device: scaler transform in float32, forward, argmax. The
        fitted state is uploaded once per fit and device and cached, so a
        warm batch uploads only its matrices. Other models classify the
        transferred features on the host in float64, as the reference does
        for KNN / naive Bayes.
        """
        if hasattr(self.model, "forward_device"):
            z = scaler_transform_device(self.scaler, feats)
            return self.model.forward_device(z).argmax(dim=1).cpu().numpy()
        return self.model.predict(self.scaler.transform(feats.cpu().numpy()))

    def accuracy(self, feats: np.ndarray, labels: np.ndarray) -> float:
        return accuracy_score(labels, self.predict_features(feats))


def train_selector(
    ds: LabeledDataset,
    model_name: str = "random_forest",
    scaling: str = "standard",
    test_size: float = 0.2,
    seed: int = 0,
    cv: int = 5,
    grid: Optional[Dict[str, Sequence]] = None,
    fast: bool = False,
    feature_set: Optional[str] = None,
    device=None,
):
    """Grid-search + refit a selector; returns (selector, report dict).

    ``model_name``/``scaling``/``feature_set`` are registry names (unknown
    ones raise :class:`~repro_torch.engine.registry.RegistryLookupError`
    with suggestions). ``feature_set`` defaults to the set the dataset was
    featurized with. The report carries everything the paper's evaluation
    needs: test accuracy, indices of the split, per-scenario totals (AMD /
    predicted / ideal — Table 6), and the mean speedup vs AMD.

    Families trained by gradient descent (``trains_on_device``: logistic
    regression, SVM, MLP) fit on ``device`` (``None`` → the card); the
    others fit on the host.
    """
    fs_name = feature_set or getattr(ds, "feature_set", None) or "paper12"
    fs = get_feature_set(fs_name)
    x, y = ds.features, ds.labels
    if x.shape[1] != fs.dim:
        raise ValueError(
            f"dataset features have dim {x.shape[1]} but feature set "
            f"{fs_name!r} has {fs.dim} ({list(fs.names)})")
    xtr, xte, ytr, yte, itr, ite = train_test_split(x, y, test_size, seed)
    scaler = SCALERS[scaling]().fit(xtr)
    grids = FAST_GRIDS if fast else DEFAULT_GRIDS
    model = MODEL_ZOO[model_name]()
    fit_params = ({"device": device}
                  if getattr(model, "trains_on_device", False) else {})
    gs = GridSearchCV(model, grid or grids.get(model_name, {}), cv=cv,
                      seed=seed, fit_params=fit_params)
    gs.fit(scaler.transform(xtr), ytr)
    sel = ReorderSelector(gs.best_model_, scaler, list(ds.algorithms),
                          feature_set=fs_name)

    pred = sel.predict_features(xte)
    acc = accuracy_score(yte, pred)

    # training-report card (persisted into SelectorBundle schema v2):
    # confusion matrix over the held-out split + per-algorithm recall
    k = len(ds.algorithms)
    confusion = np.zeros((k, k), dtype=np.int64)
    for t, q in zip(yte, pred):
        confusion[int(t), int(q)] += 1
    support = confusion.sum(axis=1)
    per_algorithm_recall = {
        alg: (float(confusion[i, i] / support[i]) if support[i] else None)
        for i, alg in enumerate(ds.algorithms)}

    amd_idx = ds.algorithms.index("amd")
    t_amd = ds.times[ite, amd_idx].sum()
    t_pred = ds.times[ite, pred].sum()
    t_ideal = ds.times[ite].min(axis=1).sum()
    speedups = ds.times[ite, amd_idx] / np.maximum(ds.times[ite, pred], 1e-12)

    report = dict(
        model=model_name, scaling=scaling,
        best_params=gs.best_params_, cv_score=gs.best_score_,
        test_accuracy=acc,
        confusion=confusion,
        per_algorithm_recall=per_algorithm_recall,
        test_support={alg: int(s) for alg, s in zip(ds.algorithms, support)},
        test_idx=ite, train_idx=itr, predictions=pred,
        time_amd=float(t_amd), time_predicted=float(t_pred),
        time_ideal=float(t_ideal),
        reduction_vs_amd=float(1.0 - t_pred / t_amd) if t_amd > 0 else 0.0,
        excess_vs_ideal=float(t_pred / t_ideal - 1.0) if t_ideal > 0 else 0.0,
        mean_speedup_vs_amd=float(speedups.mean()),
        max_speedup_vs_amd=float(speedups.max()),
    )
    return sel, report
