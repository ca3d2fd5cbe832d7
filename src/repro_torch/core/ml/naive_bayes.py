"""Copy of ``repro/core/ml/naive_bayes.py``: Gaussian naive Bayes (the
paper's "Bayesian Algorithm"), on the host."""
from __future__ import annotations

import numpy as np

from .base import BaseClassifier

__all__ = ["GaussianNB"]


class GaussianNB(BaseClassifier):
    def __init__(self, var_smoothing: float = 1e-9):
        super().__init__(var_smoothing=var_smoothing)

    def fit(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.int64)
        self.n_classes_ = int(y.max()) + 1
        k, d = self.n_classes_, x.shape[1]
        self.theta_ = np.zeros((k, d))
        self.var_ = np.ones((k, d))
        self.prior_ = np.full(k, 1.0 / k)
        eps = self.params["var_smoothing"] * max(x.var(axis=0).max(), 1e-12)
        for c in range(k):
            xc = x[y == c]
            if xc.shape[0] == 0:
                continue
            self.theta_[c] = xc.mean(axis=0)
            self.var_[c] = xc.var(axis=0) + eps
            self.prior_[c] = xc.shape[0] / x.shape[0]
        return self

    def _joint_log_likelihood(self, x):
        x = np.asarray(x, dtype=np.float64)
        jll = np.empty((x.shape[0], self.n_classes_))
        for c in range(self.n_classes_):
            ll = -0.5 * (np.log(2 * np.pi * self.var_[c])
                         + (x - self.theta_[c]) ** 2 / self.var_[c]).sum(axis=1)
            jll[:, c] = ll + np.log(max(self.prior_[c], 1e-12))
        return jll

    def predict_proba(self, x):
        jll = self._joint_log_likelihood(x)
        jll -= jll.max(axis=1, keepdims=True)
        p = np.exp(jll)
        return p / p.sum(axis=1, keepdims=True)

    def predict(self, x):
        return self._joint_log_likelihood(x).argmax(axis=1)
