"""Port of ``repro/core/ml/jax_models.py``: multinomial logistic regression,
linear / RFF-RBF SVM and MLP, trained by full-batch Adam on a device.

These are the differentiable members of the paper's Fig. 4 line-up, with the
reference's hyperparameters, defaults, losses and zero / He initializations.
``fit(x, y, device=None)`` trains on ``device`` (``None`` → the card, through
:func:`repro_torch.resolve_device`; the tests pass ``"cpu"``). Random draws
(the SVM's random Fourier features, the MLP's initial weights) come from a
CPU ``torch.Generator`` seeded with ``random_state`` and are then moved, so
the CPU and the card start from the same values; they are not the
reference's ``jax.random`` draws.

The fitted state (``state()``) holds float32 numpy arrays under the
reference's keys, so bundles stay plain data and fingerprints hash the same
bytes as the reference's for the same weights. Tensors of that state are
cached per device apart from it: ``forward_device(z)`` gives class scores on
``z``'s device, and the host ``predict`` runs the same forward on CPU
tensors, after casting its input to float32 as the reference does.
"""
from __future__ import annotations

import math
import threading
from typing import List, Sequence

import numpy as np
import torch

from ...device import resolve_device
from .base import BaseClassifier

__all__ = ["LogisticRegression", "SVMClassifier", "MLPClassifier"]


def _flatten(params) -> List[torch.Tensor]:
    if isinstance(params, (list, tuple)):
        return [t for p in params for t in _flatten(p)]
    return [params]


def _unflatten(params, it):
    if isinstance(params, (list, tuple)):
        return type(params)(_unflatten(p, it) for p in params)
    return next(it)


def _adam_train(loss_fn, params, steps: int, lr: float):
    """Full-batch Adam on the tensors' device, the reference's update in
    its float32 arithmetic: β 0.9 / 0.999, ε 1e-8 added to √v̂, and the
    bias corrections 1 − βᵗ taken in float32 as the reference's scan does
    (``torch.optim.Adam`` takes them in float64, which moves an MLP off the
    reference's trajectory within a hundred steps). ``params`` is a nested
    tuple / list of tensors; returns the trained ones in the same
    structure, detached."""
    flat = [p.detach().clone().requires_grad_(True) for p in _flatten(params)]
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    b1, b2, eps = 0.9, 0.999, 1e-8
    t = torch.arange(1, steps + 1, dtype=torch.float32)
    c1s = (1 - torch.tensor(b1, dtype=torch.float32) ** t).tolist()
    c2s = (1 - torch.tensor(b2, dtype=torch.float32) ** t).tolist()
    for c1, c2 in zip(c1s, c2s):
        for p in flat:
            p.grad = None
        loss_fn(_unflatten(params, iter(flat))).backward()
        with torch.no_grad():
            for k, p in enumerate(flat):
                g = p.grad
                m[k] = b1 * m[k] + (1 - b1) * g
                v[k] = b2 * v[k] + (1 - b2) * g * g
                p -= lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps)
    return _unflatten(params, iter(p.detach() for p in flat))


def _nll(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of the labels under softmax(logits)."""
    return -torch.log_softmax(logits, dim=1).gather(1, y[:, None]).mean()


#: guards every fitted model's per-device tensor cache (``_dev``)
_DEV_LOCK = threading.Lock()


class _TorchClassifier(BaseClassifier):
    """Shared device handling: fitted arrays ↔ cached tensors per device."""

    # fit takes a ``device`` keyword (train_selector passes the engine's)
    trains_on_device = True

    def _arrays(self) -> list:
        """The fitted numpy arrays, in the order ``_forward`` reads them."""
        raise NotImplementedError

    def _forward(self, tensors: list, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _keep(self, tensors: list) -> list:
        """Numpy copies of the trained tensors, for the fitted state; the
        tensors themselves stay cached as those arrays' copy on their
        device."""
        arrays = [t.detach().cpu().numpy() for t in tensors]
        self._dev = (tuple(arrays), {tensors[0].device: list(tensors)})
        return arrays

    def _tensors(self, device: torch.device) -> list:
        """The fitted arrays as tensors on ``device``: uploaded once per fit
        and device, keyed on the identity of the arrays (strong
        references, so a refit or ``load_state`` never aliases stale
        tensors)."""
        key = tuple(self._arrays())
        with _DEV_LOCK:  # served from several threads at once
            cached = getattr(self, "_dev", None)
            if (cached is None or len(cached[0]) != len(key)
                    or any(a is not b for a, b in zip(cached[0], key))):
                cached = self._dev = (key, {})
            if device not in cached[1]:
                cached[1][device] = [
                    torch.from_numpy(np.asarray(a)).to(device) for a in key]
            return cached[1][device]

    def forward_device(self, z: torch.Tensor) -> torch.Tensor:
        """Class scores for a float32 (B, d) tensor, on its device."""
        z = z.to(torch.float32)
        return self._forward(self._tensors(z.device), z)

    def _scores_host(self, x) -> torch.Tensor:
        x = torch.from_numpy(np.asarray(x, dtype=np.float32))
        return self.forward_device(x)

    def predict(self, x):
        return self._scores_host(x).argmax(dim=1).numpy()


class LogisticRegression(_TorchClassifier):
    def __init__(self, C: float = 1.0, steps: int = 500, lr: float = 0.05,
                 random_state: int = 0):
        super().__init__(C=C, steps=steps, lr=lr, random_state=random_state)

    def fit(self, x, y, device=None):
        dev = resolve_device(device)
        x = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)
        y = np.asarray(y, dtype=np.int64)
        self.n_classes_ = int(y.max()) + 1
        k, d = self.n_classes_, x.shape[1]
        yt = torch.from_numpy(y).to(dev)
        p = self.params
        w = torch.zeros((d, k), dtype=torch.float32, device=dev)
        b = torch.zeros((k,), dtype=torch.float32, device=dev)

        def loss(params):
            w, b = params
            ce = _nll(x @ w + b, yt)
            return ce + (0.5 / p["C"]) * (w ** 2).sum() / x.shape[0]

        self.w_, self.b_ = self._keep(list(_adam_train(
            loss, (w, b), p["steps"], p["lr"])))
        return self

    def _arrays(self):
        return [self.w_, self.b_]

    def _forward(self, tensors, x):
        w, b = tensors
        return x @ w + b

    def predict_proba(self, x):
        return torch.softmax(self._scores_host(x), dim=1).numpy()


class SVMClassifier(_TorchClassifier):
    """One-vs-rest hinge-loss SVM; kernel='rbf' uses random Fourier features
    (Rahimi–Recht) so the optimization stays a linear problem."""

    def __init__(self, C: float = 1.0, kernel: str = "rbf", gamma: float = 0.5,
                 n_components: int = 256, steps: int = 500, lr: float = 0.05,
                 random_state: int = 0):
        super().__init__(C=C, kernel=kernel, gamma=gamma,
                         n_components=n_components, steps=steps, lr=lr,
                         random_state=random_state)

    def _rbf(self) -> bool:
        return self.params["kernel"] != "linear"

    def _featurize(self, x, rff_w=None, rff_b=None):
        if not self._rbf():
            return x
        return math.sqrt(2.0 / self.params["n_components"]) * torch.cos(
            x @ rff_w + rff_b)

    def fit(self, x, y, device=None):
        p = self.params
        dev = resolve_device(device)
        x = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)
        y = np.asarray(y, dtype=np.int64)
        self.n_classes_ = int(y.max()) + 1
        d, n = x.shape[1], x.shape[0]
        rff = []
        if self._rbf():
            g = torch.Generator().manual_seed(int(p["random_state"]))
            nc = p["n_components"]
            rff_w = math.sqrt(2.0 * p["gamma"]) * torch.randn(
                (d, nc), generator=g, dtype=torch.float32)
            rff_b = torch.rand((nc,), generator=g,
                               dtype=torch.float32) * (2 * math.pi)
            rff = [rff_w.to(dev), rff_b.to(dev)]
        phi = self._featurize(x, *rff)
        # one-vs-rest targets in {-1, +1}
        t = -torch.ones((n, self.n_classes_), dtype=torch.float32, device=dev)
        t[torch.arange(n, device=dev), torch.from_numpy(y).to(dev)] = 1.0
        w = torch.zeros((phi.shape[1], self.n_classes_), dtype=torch.float32,
                        device=dev)
        b = torch.zeros((self.n_classes_,), dtype=torch.float32, device=dev)

        def loss(params):
            w, b = params
            hinge = torch.clamp_min(1.0 - t * (phi @ w + b), 0.0).mean()
            return p["C"] * hinge + 0.5 * (w ** 2).sum() / phi.shape[0]

        w, b = _adam_train(loss, (w, b), p["steps"], p["lr"])
        *rff, self.w_, self.b_ = self._keep(rff + [w, b])
        if rff:
            self.rff_w_, self.rff_b_ = rff
        return self

    def _arrays(self):
        rff = [self.rff_w_, self.rff_b_] if self._rbf() else []
        return rff + [self.w_, self.b_]

    def _forward(self, tensors, x):
        *rff, w, b = tensors
        return self._featurize(x, *rff) @ w + b

    def decision_function(self, x):
        return self._scores_host(x).numpy()


def _mlp_forward(params, x):
    h = x
    for (w, b) in params[:-1]:
        h = torch.relu(h @ w + b)
    w, b = params[-1]
    return h @ w + b


def _mlp_init(sizes: Sequence[int], random_state: int) -> list:
    """He-normal weights and zero biases, one ``(w, b)`` per layer, drawn
    on the CPU from a generator seeded with ``random_state``."""
    g = torch.Generator().manual_seed(int(random_state))
    return [(math.sqrt(2.0 / sizes[i]) * torch.randn(
                (sizes[i], sizes[i + 1]), generator=g, dtype=torch.float32),
             torch.zeros((sizes[i + 1],), dtype=torch.float32))
            for i in range(len(sizes) - 1)]


class MLPClassifier(_TorchClassifier):
    def __init__(self, hidden_layer_sizes: Sequence[int] = (64, 32),
                 steps: int = 800, lr: float = 0.01, alpha: float = 1e-4,
                 random_state: int = 0):
        super().__init__(hidden_layer_sizes=tuple(hidden_layer_sizes),
                         steps=steps, lr=lr, alpha=alpha,
                         random_state=random_state)

    def fit(self, x, y, device=None):
        p = self.params
        dev = resolve_device(device)
        x = torch.from_numpy(np.asarray(x, dtype=np.float32)).to(dev)
        y = np.asarray(y, dtype=np.int64)
        self.n_classes_ = int(y.max()) + 1
        yt = torch.from_numpy(y).to(dev)
        sizes = [x.shape[1], *p["hidden_layer_sizes"], self.n_classes_]
        params = [(w.to(dev), b.to(dev))
                  for w, b in _mlp_init(sizes, p["random_state"])]

        def loss(params):
            l2 = sum((w ** 2).sum() for (w, _) in params)
            return _nll(_mlp_forward(params, x), yt) + p["alpha"] * l2

        a = self._keep(_flatten(_adam_train(loss, params, p["steps"],
                                            p["lr"])))
        self.params_ = list(zip(a[::2], a[1::2]))
        return self

    def _arrays(self):
        return _flatten(self.params_)

    def _forward(self, tensors, x):
        return _mlp_forward(list(zip(tensors[::2], tensors[1::2])), x)

    def predict_proba(self, x):
        return torch.softmax(self._scores_host(x), dim=1).numpy()
