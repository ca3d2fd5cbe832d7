"""Copy of ``repro/core/ml/random_forest.py``: bagged CART trees with
sqrt-feature subsampling, trained on the host with numpy (same data and
seed → the reference's node arrays); ``forward_device`` is the port of
``forward_jnp``.

The paper's winning model (Fig. 4 / Table 4: gini, min_samples_leaf=1,
min_samples_split=5, n_estimators=100).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .base import BaseClassifier
from .decision_tree import DecisionTreeClassifier

__all__ = ["RandomForestClassifier"]


class RandomForestClassifier(BaseClassifier):
    def __init__(self, n_estimators: int = 100, criterion: str = "gini",
                 max_depth: Optional[int] = None, min_samples_split: int = 2,
                 min_samples_leaf: int = 1, bootstrap: bool = True,
                 random_state: int = 0):
        super().__init__(n_estimators=n_estimators, criterion=criterion,
                         max_depth=max_depth,
                         min_samples_split=min_samples_split,
                         min_samples_leaf=min_samples_leaf,
                         bootstrap=bootstrap, random_state=random_state)

    def fit(self, x: np.ndarray, y: np.ndarray) -> "RandomForestClassifier":
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.int64)
        self.n_classes_ = int(y.max()) + 1 if y.size else 1
        p = self.params
        rng = np.random.default_rng(p["random_state"])
        n = x.shape[0]
        self.trees_ = []
        for t in range(p["n_estimators"]):
            idx = (rng.integers(0, n, n) if p["bootstrap"]
                   else np.arange(n))
            tree = DecisionTreeClassifier(
                criterion=p["criterion"], max_depth=p["max_depth"],
                min_samples_split=p["min_samples_split"],
                min_samples_leaf=p["min_samples_leaf"],
                max_features="sqrt",
                random_state=int(rng.integers(0, 2**31 - 1)))
            # classes present in the bootstrap may be a subset; force k
            tree.n_classes_ = self.n_classes_
            tree._rng = np.random.default_rng(tree.params["random_state"])
            tree.root_ = tree._build(x[idx], y[idx], depth=0)
            self.trees_.append(tree)
        return self

    # -- persistence ----------------------------------------------------------
    def state(self) -> dict:
        """Per-tree flat node arrays (see ``DecisionTreeClassifier.state``)."""
        if not hasattr(self, "trees_"):
            return {}
        return dict(n_classes_=int(self.n_classes_),
                    trees=[t.state() for t in self.trees_])

    def load_state(self, state: dict) -> "RandomForestClassifier":
        if not state:
            return self
        self.n_classes_ = int(state["n_classes_"])
        self.trees_ = [DecisionTreeClassifier().load_state(ts)
                       for ts in state["trees"]]
        return self

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        acc = np.zeros((x.shape[0], self.n_classes_))
        for tree in self.trees_:
            acc += tree.predict_proba(x)
        return acc / len(self.trees_)

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.predict_proba(x).argmax(axis=1)

    def forward_device(self, x):
        """Scores (B, k) on the device of the (B, d) tensor ``x``: mean
        per-tree leaf probabilities via the flattened forest
        (:mod:`repro_torch.core.ml.forest_torch`); keeps forest selection
        on the card in ``ReorderSelector.select_batch``."""
        from .forest_torch import forest_forward
        return forest_forward(self, x)

    def feature_importances(self, x: np.ndarray, y: np.ndarray,
                            n_repeats: int = 3, seed: int = 0) -> np.ndarray:
        """Permutation importance (used by the EXPERIMENTS feature study)."""
        rng = np.random.default_rng(seed)
        base = self.score(x, y)
        d = x.shape[1]
        imp = np.zeros(d)
        for f in range(d):
            drops = []
            for _ in range(n_repeats):
                xp = np.array(x, dtype=np.float64)
                xp[:, f] = rng.permutation(xp[:, f])
                drops.append(base - self.score(xp, y))
            imp[f] = float(np.mean(drops))
        return imp
