"""Port of ``repro/core/ml/__init__.py``: the model families that classify
on the card, registered in
:data:`repro_torch.engine.registry.MODEL_REGISTRY` under the reference's
names — ``random_forest`` (the paper's winning model) and
``decision_tree``. ``MODEL_ZOO`` is that registry.

Not ported yet: ``logistic_regression``, ``svm`` and ``mlp`` (trained with
JAX in the reference), ``knn`` and ``naive_bayes``.
"""
from ...engine.registry import MODEL_REGISTRY, register_model
from .base import BaseClassifier, accuracy_score
from .decision_tree import DecisionTreeClassifier
from .forest_torch import (ForestArrays, arrays_to_tree, forest_forward_device,
                           forest_to_arrays, tree_to_arrays)
from .random_forest import RandomForestClassifier

# device_capable: fitted instances expose forward_device, so select_batch's
# scaler + forward + argmax run on the card
register_model("random_forest", device_capable=True)(RandomForestClassifier)
register_model("decision_tree", device_capable=True)(DecisionTreeClassifier)

MODEL_ZOO = MODEL_REGISTRY

__all__ = [
    "BaseClassifier", "accuracy_score", "DecisionTreeClassifier",
    "RandomForestClassifier", "MODEL_ZOO", "MODEL_REGISTRY", "register_model",
    "ForestArrays", "tree_to_arrays", "arrays_to_tree", "forest_to_arrays",
    "forest_forward_device",
]
