"""Copy of ``repro/core/ml/base.py``: a minimal scikit-learn-flavoured
classifier API (fit/predict/score/clone, ``state``/``load_state``,
``fingerprint``)."""
from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np

__all__ = ["BaseClassifier", "accuracy_score"]


def accuracy_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Acc = P_true / P_all (paper Eq. 4)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    return float((y_true == y_pred).mean()) if y_true.size else 0.0


class BaseClassifier:
    """Subclasses set hyperparameters in __init__ via explicit kwargs and
    record them in ``self.params`` (used by clone / grid search)."""

    params: Dict[str, Any]

    def __init__(self, **params: Any) -> None:
        self.params = dict(params)

    def clone(self) -> "BaseClassifier":
        return type(self)(**copy.deepcopy(self.params))

    def with_params(self, **updates: Any) -> "BaseClassifier":
        p = dict(self.params)
        p.update(updates)
        return type(self)(**p)

    # persistence / identity ------------------------------------------------
    def state(self) -> Dict[str, Any]:
        """Fitted state as a plain dict — the sklearn convention of trailing
        underscores marks fitted attributes, so the default collects those.
        Families whose fitted state is an object graph (trees) override
        this to return arrays, keeping bundles array-only and fingerprints
        deterministic. Empty for an unfitted instance."""
        return {k: v for k, v in vars(self).items()
                if k.endswith("_") and not k.startswith("_")}

    def load_state(self, state: Dict[str, Any]) -> "BaseClassifier":
        for k, v in state.items():
            setattr(self, k, v)
        return self

    def fingerprint(self) -> str:
        """Stable hash of class + hyperparameters + fitted state; changes on
        every refit, which is what lets the engine version its plan cache
        off the served model automatically."""
        from ...engine.fingerprint import component_fingerprint
        return component_fingerprint(self)

    # subclass contract -----------------------------------------------------
    def fit(self, x: np.ndarray, y: np.ndarray) -> "BaseClassifier":
        raise NotImplementedError

    def predict(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        # default: one-hot of predict
        pred = self.predict(x)
        k = int(self.n_classes_)
        out = np.zeros((pred.shape[0], k))
        out[np.arange(pred.shape[0]), pred] = 1.0
        return out

    def score(self, x: np.ndarray, y: np.ndarray) -> float:
        return accuracy_score(y, self.predict(x))
