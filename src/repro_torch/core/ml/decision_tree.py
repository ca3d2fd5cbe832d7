"""Copy of ``repro/core/ml/decision_tree.py``: CART decision tree (gini /
entropy), vectorized split search, trained on the host with numpy. The same
data and seed give the reference's node arrays. ``forward_device`` (the
port of ``forward_jnp``) classifies a feature tensor on its device
(:mod:`repro_torch.core.ml.forest_torch`)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from .base import BaseClassifier

__all__ = ["DecisionTreeClassifier"]


def _impurity(counts: np.ndarray, criterion: str) -> np.ndarray:
    """counts: (..., k) class counts → impurity per row."""
    total = counts.sum(axis=-1, keepdims=True)
    p = counts / np.maximum(total, 1)
    if criterion == "gini":
        return 1.0 - (p ** 2).sum(axis=-1)
    logp = np.where(p > 0, np.log2(np.maximum(p, 1e-12)), 0.0)
    return -(p * logp).sum(axis=-1)


class _Node:
    __slots__ = ("feature", "threshold", "left", "right", "value")

    def __init__(self, value):
        self.feature: int = -1
        self.threshold: float = 0.0
        self.left: Optional["_Node"] = None
        self.right: Optional["_Node"] = None
        self.value = value  # class-count vector


class DecisionTreeClassifier(BaseClassifier):
    def __init__(self, criterion: str = "gini", max_depth: Optional[int] = None,
                 min_samples_split: int = 2, min_samples_leaf: int = 1,
                 max_features: Optional[str] = None, random_state: int = 0):
        super().__init__(criterion=criterion, max_depth=max_depth,
                         min_samples_split=min_samples_split,
                         min_samples_leaf=min_samples_leaf,
                         max_features=max_features, random_state=random_state)

    def fit(self, x: np.ndarray, y: np.ndarray) -> "DecisionTreeClassifier":
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.int64)
        self.n_classes_ = int(y.max()) + 1 if y.size else 1
        self._rng = np.random.default_rng(self.params["random_state"])
        self.root_ = self._build(x, y, depth=0)
        return self

    # -- split search --------------------------------------------------------
    def _best_split(self, x, y):
        p = self.params
        n, d = x.shape
        k = self.n_classes_
        feats = np.arange(d)
        if p["max_features"] == "sqrt":
            m = max(1, int(np.sqrt(d)))
            feats = self._rng.choice(d, size=m, replace=False)
        best = (None, None, np.inf)  # feature, threshold, score
        min_leaf = p["min_samples_leaf"]
        onehot = np.zeros((n, k))
        onehot[np.arange(n), y] = 1.0
        for f in feats:
            order = np.argsort(x[:, f], kind="stable")
            xs = x[order, f]
            cum = np.cumsum(onehot[order], axis=0)  # counts left of cut i+1
            total = cum[-1]
            # candidate cuts between distinct consecutive values
            valid = np.nonzero(xs[1:] > xs[:-1])[0]  # cut after index i
            if valid.size == 0:
                continue
            nl = valid + 1
            nr = n - nl
            ok = (nl >= min_leaf) & (nr >= min_leaf)
            valid, nl, nr = valid[ok], nl[ok], nr[ok]
            if valid.size == 0:
                continue
            left_counts = cum[valid]
            right_counts = total[None, :] - left_counts
            imp = (nl * _impurity(left_counts, p["criterion"])
                   + nr * _impurity(right_counts, p["criterion"])) / n
            i = int(np.argmin(imp))
            if imp[i] < best[2]:
                thr = 0.5 * (xs[valid[i]] + xs[valid[i] + 1])
                best = (int(f), float(thr), float(imp[i]))
        return best

    def _build(self, x, y, depth):
        p = self.params
        counts = np.bincount(y, minlength=self.n_classes_).astype(np.float64)
        node = _Node(counts)
        if (y.size < p["min_samples_split"]
                or (p["max_depth"] is not None and depth >= p["max_depth"])
                or np.unique(y).size <= 1):
            return node
        parent_imp = _impurity(counts[None, :], p["criterion"])[0]
        f, thr, score = self._best_split(x, y)
        if f is None or score >= parent_imp - 1e-12:
            return node
        mask = x[:, f] <= thr
        node.feature, node.threshold = f, thr
        node.left = self._build(x[mask], y[mask], depth + 1)
        node.right = self._build(x[~mask], y[~mask], depth + 1)
        return node

    # -- persistence ----------------------------------------------------------
    def state(self) -> dict:
        """Fitted tree as flat node arrays (schema of ``tree_to_arrays``) —
        no linked ``_Node`` objects leave the process, so bundle payloads
        and fingerprints are plain deterministic arrays."""
        if not hasattr(self, "root_"):
            return {}
        from .forest_torch import tree_to_arrays
        f, t, lf, rg, v, _ = tree_to_arrays(self.root_, self.n_classes_,
                                            normalize=False)
        return dict(n_classes_=int(self.n_classes_),
                    feature=np.asarray(f, np.int32),
                    threshold=np.asarray(t, np.float64),
                    left=np.asarray(lf, np.int32),
                    right=np.asarray(rg, np.int32),
                    value=np.asarray(v, np.float64))

    def load_state(self, state: dict) -> "DecisionTreeClassifier":
        if not state:
            return self
        from .forest_torch import arrays_to_tree
        self.n_classes_ = int(state["n_classes_"])
        self.root_ = arrays_to_tree(state["feature"], state["threshold"],
                                    state["left"], state["right"],
                                    state["value"])
        return self

    # -- inference ------------------------------------------------------------
    def _leaf_counts(self, x: np.ndarray) -> np.ndarray:
        out = np.empty((x.shape[0], self.n_classes_))
        for i, row in enumerate(x):
            node = self.root_
            while node.left is not None:
                node = node.left if row[node.feature] <= node.threshold else node.right
            out[i] = node.value
        return out

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        c = self._leaf_counts(np.asarray(x, dtype=np.float64))
        return c / np.maximum(c.sum(axis=1, keepdims=True), 1)

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.predict_proba(x).argmax(axis=1)

    def forward_device(self, x):
        """Scores (B, k) on the device of the (B, d) tensor ``x``: leaf
        probabilities by flattened-node traversal
        (:mod:`repro_torch.core.ml.forest_torch`)."""
        from .forest_torch import forest_forward
        return forest_forward(self, x)
