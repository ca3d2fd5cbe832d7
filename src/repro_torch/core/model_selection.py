"""Copy of ``repro/core/model_selection.py``: dataset splitting, k-fold
cross-validation and grid search (paper §3.4)."""
from __future__ import annotations

import itertools
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .ml.base import BaseClassifier, accuracy_score

__all__ = ["train_test_split", "kfold_indices", "cross_val_score",
           "GridSearchCV"]


def train_test_split(x: np.ndarray, y: np.ndarray, test_size: float = 0.2,
                     seed: int = 0, stratify: bool = True):
    """8:2 split (paper default); stratified so rare labels appear in both."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    if stratify:
        test_idx: List[int] = []
        for c in np.unique(y):
            idx = np.nonzero(y == c)[0]
            idx = rng.permutation(idx)
            k = max(1, int(round(test_size * idx.size))) if idx.size > 1 else 0
            test_idx.extend(idx[:k].tolist())
        test_mask = np.zeros(n, dtype=bool)
        test_mask[test_idx] = True
    else:
        perm = rng.permutation(n)
        test_mask = np.zeros(n, dtype=bool)
        test_mask[perm[: int(round(test_size * n))]] = True
    return (x[~test_mask], x[test_mask], y[~test_mask], y[test_mask],
            np.nonzero(~test_mask)[0], np.nonzero(test_mask)[0])


def kfold_indices(n: int, k: int = 5, seed: int = 0) -> List[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    folds = np.array_split(perm, k)
    out = []
    for i in range(k):
        val = folds[i]
        train = np.concatenate([folds[j] for j in range(k) if j != i])
        out.append((train, val))
    return out


def cross_val_score(model: BaseClassifier, x: np.ndarray, y: np.ndarray,
                    cv: int = 5, seed: int = 0,
                    fit_params: Optional[Dict[str, Any]] = None) -> float:
    scores = []
    for train, val in kfold_indices(x.shape[0], cv, seed):
        m = model.clone()
        m.fit(x[train], y[train], **(fit_params or {}))
        scores.append(m.score(x[val], y[val]))
    return float(np.mean(scores))


class GridSearchCV:
    """Exhaustive grid search with k-fold CV (paper Fig. 3).

    ``param_grid``: mapping name → candidate values. After ``fit``,
    ``best_model_`` is refit on the full training data with the best combo.
    ``fit_params`` are passed to every ``fit`` (the port's ``device``).
    """

    def __init__(self, model: BaseClassifier, param_grid: Dict[str, Sequence[Any]],
                 cv: int = 5, seed: int = 0,
                 fit_params: Optional[Dict[str, Any]] = None):
        self.model = model
        self.param_grid = param_grid
        self.cv = cv
        self.seed = seed
        self.fit_params = dict(fit_params or {})

    def _combos(self) -> Iterable[Dict[str, Any]]:
        keys = sorted(self.param_grid)
        for values in itertools.product(*(self.param_grid[k] for k in keys)):
            yield dict(zip(keys, values))

    def fit(self, x: np.ndarray, y: np.ndarray) -> "GridSearchCV":
        self.results_: List[Tuple[Dict[str, Any], float]] = []
        best = (None, -1.0)
        for combo in self._combos():
            m = self.model.with_params(**combo)
            score = cross_val_score(m, x, y, self.cv, self.seed,
                                    self.fit_params)
            self.results_.append((combo, score))
            if score > best[1]:
                best = (combo, score)
        self.best_params_, self.best_score_ = best
        self.best_model_ = self.model.with_params(**self.best_params_)
        self.best_model_.fit(x, y, **self.fit_params)
        return self

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.best_model_.predict(x)

    def score(self, x: np.ndarray, y: np.ndarray) -> float:
        return accuracy_score(y, self.predict(x))
