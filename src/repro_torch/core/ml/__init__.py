"""Port of ``repro/core/ml/__init__.py``: the seven model families of the
paper's Fig. 4, registered in
:data:`repro_torch.engine.registry.MODEL_REGISTRY` under the reference's
names. ``MODEL_ZOO`` is that registry (a ``Mapping``); third-party families
plug in with ``@register_model("name")``.
"""
from ...engine.registry import MODEL_REGISTRY, register_model
from .base import BaseClassifier, accuracy_score
from .decision_tree import DecisionTreeClassifier
from .forest_torch import (ForestArrays, arrays_to_tree, forest_forward_device,
                           forest_to_arrays, tree_to_arrays)
from .knn import KNeighborsClassifier
from .naive_bayes import GaussianNB
from .random_forest import RandomForestClassifier
from .torch_models import LogisticRegression, MLPClassifier, SVMClassifier

# device_capable: fitted instances expose forward_device, so select_batch's
# scaler + forward + argmax run on the card (trees/forests via forest_torch)
register_model("random_forest", device_capable=True)(RandomForestClassifier)
register_model("decision_tree", device_capable=True)(DecisionTreeClassifier)
register_model("logistic_regression", device_capable=True)(LogisticRegression)
register_model("naive_bayes")(GaussianNB)
register_model("svm", device_capable=True)(SVMClassifier)
register_model("mlp", device_capable=True)(MLPClassifier)
register_model("knn")(KNeighborsClassifier)

MODEL_ZOO = MODEL_REGISTRY

__all__ = [
    "BaseClassifier", "accuracy_score", "DecisionTreeClassifier",
    "RandomForestClassifier", "LogisticRegression", "SVMClassifier",
    "MLPClassifier", "GaussianNB", "KNeighborsClassifier", "MODEL_ZOO",
    "MODEL_REGISTRY", "register_model",
    "ForestArrays", "tree_to_arrays", "arrays_to_tree", "forest_to_arrays",
    "forest_forward_device",
]
