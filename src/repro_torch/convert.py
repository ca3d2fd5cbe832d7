"""State carried across from the JAX package as plain data.

:func:`plan_arrays` reads the arrays of any plan with the reference's field
names (``fingerprint``, ``algorithm``, ``perm`` and a ``sym`` with
``parent``, ``counts``, ``Lp``, ``Li``, ``flops``, ``fill``) — a
``repro.core.plan.ExecutionPlan`` as well as this package's — without
importing ``repro``. :func:`plan_from_arrays` builds the port's
:class:`~repro_torch.core.plan.ExecutionPlan` from them, so both packages
can execute the same plan.

:func:`classifier_state_arrays` turns a classifier's fitted state
(``state()`` of either package) into the port's: array leaves of other
types — the ``jax.Array`` weights of the reference's logistic regression,
SVM and MLP — become numpy arrays of the same dtype and bytes, and the
containers stay as they are, so the fingerprint does not change.
:func:`selector_bundle_arrays` reads the fields of a selector bundle — a
``repro.engine.SelectorBundle``, this package's, or any object with their
names — as plain dicts, lists and numpy arrays (the model state through
:func:`classifier_state_arrays`), and :func:`bundle_from_arrays` builds the
port's validated :class:`~repro_torch.engine.bundle.SelectorBundle` from
them, with the same fingerprint.

:func:`lm_params_from_jax` builds the port's language-model parameters
(:mod:`repro_torch.models.transformer`) from the reference's nested dict of
numpy arrays, one entry per layer where the reference stacks layer groups;
:func:`lm_opt_state_from_jax` does the same for the reference's AdamW state
(``repro.train.init_opt_state``: ``master``, ``m`` and ``v`` laid out like
the parameters, and ``count``).
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .core.plan import ExecutionPlan
from .device import resolve_device
from .engine.bundle import SelectorBundle
from .models.config import ModelConfig
from .sparse.symbolic import SymbolicFactor

__all__ = ["plan_arrays", "plan_from_arrays", "classifier_state_arrays",
           "selector_bundle_arrays", "bundle_from_arrays",
           "lm_params_from_jax", "lm_opt_state_from_jax"]


def plan_arrays(plan) -> dict:
    """The keyword arguments of :func:`plan_from_arrays` for ``plan``."""
    sym = plan.sym
    return dict(fingerprint=plan.fingerprint, algorithm=plan.algorithm,
                perm=np.asarray(plan.perm), parent=np.asarray(sym.parent),
                counts=np.asarray(sym.counts), Lp=np.asarray(sym.Lp),
                Li=np.asarray(sym.Li), flops=int(sym.flops),
                fill=int(sym.fill))


def plan_from_arrays(fingerprint: str, algorithm: str, perm, parent, counts,
                     Lp, Li, flops: int, fill: int) -> ExecutionPlan:
    """The port's plan from the numpy arrays of a plan or symbolic factor
    (``perm[new] = old``; ``Lp``/``Li`` the CSC pattern of L)."""
    sym = SymbolicFactor(np.asarray(parent, dtype=np.int64),
                         np.asarray(counts, dtype=np.int64),
                         np.asarray(Lp, dtype=np.int64),
                         np.asarray(Li, dtype=np.int64), int(flops),
                         int(fill))
    return ExecutionPlan(str(fingerprint), str(algorithm),
                         np.asarray(perm, dtype=np.int64), sym, int(flops))


def classifier_state_arrays(state):
    """``state`` with every array leaf that is not a numpy array (nor a
    numpy scalar) copied into a numpy array of its dtype; dicts, lists,
    tuples and every other leaf are kept as they are."""
    if isinstance(state, dict):
        return {k: classifier_state_arrays(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(classifier_state_arrays(v) for v in state)
    if (not isinstance(state, (np.ndarray, np.generic))
            and hasattr(state, "__array__") and hasattr(state, "dtype")):
        return np.array(state)
    return state


def selector_bundle_arrays(bundle) -> dict:
    """The keyword arguments of :func:`bundle_from_arrays` for ``bundle``:
    every field of :class:`SelectorBundle`, deep-copied as plain data, the
    model state through :func:`classifier_state_arrays`."""
    fields = {f.name: copy.deepcopy(getattr(bundle, f.name))
              for f in dataclasses.fields(SelectorBundle)}
    fields["model_state"] = classifier_state_arrays(fields["model_state"])
    return fields


def bundle_from_arrays(**fields) -> SelectorBundle:
    """The port's bundle from the fields of a bundle (validated: the
    registry names resolve here, the feature schema matches, and the
    fingerprint recomputes to the stored one)."""
    return SelectorBundle(**fields).validate()


def _lm_leaf(a, device: torch.device) -> torch.Tensor:
    """One parameter array as a tensor of the same dtype. A bfloat16 array
    (numpy's ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses)
    goes through float32, which holds every bfloat16 value exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def lm_params_from_jax(cfg: ModelConfig, params, device=None) -> dict:
    """The port's parameters for ``cfg`` from the reference's
    (``repro.models.init_params``) nested dict of arrays: ``embed``,
    ``lm_head`` and ``final_norm`` as they are, and ``groups`` — every leaf
    stacked over ``cfg.num_groups`` groups of ``cfg.pattern_period`` slots
    ``s0``, ``s1``, ... — unstacked so that layer g · period + j is group g's
    slot j. Values are copied bit for bit, on ``device`` (default: the
    card). Every leaf of every slot crosses as it is: attention, MLPs
    (dense or MoE), Mamba, mLSTM and sLSTM."""
    dev = resolve_device(device)

    def tree(node, g):
        if isinstance(node, dict):
            return {k: tree(v, g) for k, v in node.items()}
        return _lm_leaf(np.asarray(node)[g], dev)

    out = {k: _lm_leaf(params[k], dev)
           for k in ("embed", "final_norm", "lm_head") if k in params}
    out["layers"] = [tree(params["groups"][f"s{j}"], g)
                     for g in range(cfg.num_groups)
                     for j in range(cfg.pattern_period)]
    return out


def lm_opt_state_from_jax(cfg: ModelConfig, opt_state, device=None) -> dict:
    """The port's optimizer state (:mod:`repro_torch.train.optimizer`) from
    the reference's: ``master``, ``m`` and ``v`` unstacked as
    :func:`lm_params_from_jax` unstacks the parameters, ``count`` a 0-d
    int32 tensor; values bit for bit, on ``device`` (default: the card)."""
    dev = resolve_device(device)
    out = {k: lm_params_from_jax(cfg, opt_state[k], dev)
           for k in ("master", "m", "v")}
    out["count"] = torch.tensor(int(np.asarray(opt_state["count"])),
                                dtype=torch.int32, device=dev)
    return out
