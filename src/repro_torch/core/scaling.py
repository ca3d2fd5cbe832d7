"""Copy of ``repro/core/scaling.py``: feature normalization, Max-Min
scaling and Standardization (paper §4.2), plus the identity scaler, with
``state``/``load_state``, and :func:`scaler_transform_device`, the port of
``repro/core/selector.py::scaler_transform_jnp`` (:36).

Scalers register in :data:`repro_torch.engine.registry.SCALER_REGISTRY`
under the reference's names (``none``, ``minmax``, ``standard``);
``SCALERS`` is that registry.
"""
from __future__ import annotations

import numpy as np

import torch

from ..engine.registry import SCALER_REGISTRY, register_scaler

__all__ = ["MinMaxScaler", "StandardScaler", "IdentityScaler", "SCALERS",
           "SCALER_REGISTRY", "register_scaler", "scaler_transform_device"]


@register_scaler("none")
class IdentityScaler:
    def fit(self, x: np.ndarray) -> "IdentityScaler":
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, dtype=np.float64)

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)

    def state(self) -> dict:
        return {}

    def load_state(self, state: dict) -> None:
        pass

    def fingerprint(self) -> str:
        """Stable hash of class + fitted state (see engine.fingerprint)."""
        from ..engine.fingerprint import component_fingerprint
        return component_fingerprint(self)


@register_scaler("minmax")
class MinMaxScaler(IdentityScaler):
    def fit(self, x: np.ndarray) -> "MinMaxScaler":
        x = np.asarray(x, dtype=np.float64)
        self.min_ = x.min(axis=0)
        span = x.max(axis=0) - self.min_
        self.scale_ = np.where(span > 0, span, 1.0)
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, dtype=np.float64) - self.min_) / self.scale_

    def state(self) -> dict:
        return dict(min=self.min_, scale=self.scale_)

    def load_state(self, state: dict) -> None:
        self.min_, self.scale_ = state["min"], state["scale"]


@register_scaler("standard")
class StandardScaler(IdentityScaler):
    def fit(self, x: np.ndarray) -> "StandardScaler":
        x = np.asarray(x, dtype=np.float64)
        self.mean_ = x.mean(axis=0)
        std = x.std(axis=0)
        self.std_ = np.where(std > 0, std, 1.0)
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, dtype=np.float64) - self.mean_) / self.std_

    def state(self) -> dict:
        return dict(mean=self.mean_, std=self.std_)

    def load_state(self, state: dict) -> None:
        self.mean_, self.std_ = state["mean"], state["std"]


SCALERS = SCALER_REGISTRY


def scaler_transform_device(scaler, x: torch.Tensor) -> torch.Tensor:
    """``scaler.transform`` on a float32 tensor, on its device: the fitted
    affine map in float32, as the reference's device path applies it. The
    state is uploaded once per fit and device and kept on the scaler, so a
    warm batch uploads nothing."""
    st = scaler.state()
    if not st:
        return x
    shift, div = ((st["mean"], st["std"]) if "mean" in st
                  else (st["min"], st["scale"]))
    cached = getattr(scaler, "_device_state", None)
    if (cached is None or cached[0] != x.device or cached[1] is not shift
            or cached[2] is not div):
        # strong references to the fitted arrays, not their ids: a refit
        # frees them, and a new array could reuse an address
        cached = scaler._device_state = (x.device, shift, div, *(
            torch.as_tensor(np.asarray(v), dtype=torch.float32).to(x.device)
            for v in (shift, div)))
    return (x - cached[3]) / cached[4]
