"""Copy of ``repro/core/ml/knn.py``: k-nearest-neighbour classifier
(euclidean / manhattan), on the host."""
from __future__ import annotations

import numpy as np

from .base import BaseClassifier

__all__ = ["KNeighborsClassifier"]


class KNeighborsClassifier(BaseClassifier):
    def __init__(self, n_neighbors: int = 5, weights: str = "uniform",
                 metric: str = "euclidean"):
        super().__init__(n_neighbors=n_neighbors, weights=weights,
                         metric=metric)

    def fit(self, x, y):
        self.x_ = np.asarray(x, dtype=np.float64)
        self.y_ = np.asarray(y, dtype=np.int64)
        self.n_classes_ = int(self.y_.max()) + 1
        return self

    def _dist(self, x):
        if self.params["metric"] == "manhattan":
            return np.abs(x[:, None, :] - self.x_[None, :, :]).sum(-1)
        d2 = ((x ** 2).sum(1)[:, None] - 2 * x @ self.x_.T
              + (self.x_ ** 2).sum(1)[None, :])
        return np.sqrt(np.maximum(d2, 0.0))

    def predict_proba(self, x):
        x = np.asarray(x, dtype=np.float64)
        k = min(self.params["n_neighbors"], self.x_.shape[0])
        dist = self._dist(x)
        nn = np.argpartition(dist, k - 1, axis=1)[:, :k]
        out = np.zeros((x.shape[0], self.n_classes_))
        for i in range(x.shape[0]):
            labels = self.y_[nn[i]]
            if self.params["weights"] == "distance":
                w = 1.0 / np.maximum(dist[i, nn[i]], 1e-12)
            else:
                w = np.ones(k)
            np.add.at(out[i], labels, w)
        return out / np.maximum(out.sum(axis=1, keepdims=True), 1e-12)

    def predict(self, x):
        return self.predict_proba(x).argmax(axis=1)
