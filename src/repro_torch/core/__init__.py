"""The paper's primary contribution in the port: supervised selection of
sparse matrix reordering algorithms. features → scaler → classifier →
{AMD, SCOTCH, ND, RCM}, trained on argmin-solve-time labels
(:mod:`repro_torch.core.labeling`) over the matrix suite
(:mod:`repro_torch.sparse.dataset`), solved by the multifrontal solver
(:mod:`repro_torch.sparse.multifrontal`)."""
from .features import FEATURE_NAMES, extract_features, extract_features_batch
from .labeling import LabeledDataset, load_or_build, run_labeling_campaign
from .ml import MODEL_ZOO, accuracy_score
from .model_selection import GridSearchCV, cross_val_score, train_test_split
from .scaling import SCALERS, MinMaxScaler, StandardScaler
from .selector import DEFAULT_GRIDS, ReorderSelector, train_selector

__all__ = [
    "FEATURE_NAMES", "extract_features", "extract_features_batch",
    "LabeledDataset", "load_or_build", "run_labeling_campaign",
    "MODEL_ZOO", "accuracy_score",
    "GridSearchCV", "cross_val_score", "train_test_split",
    "SCALERS", "MinMaxScaler", "StandardScaler",
    "DEFAULT_GRIDS", "ReorderSelector", "train_selector",
]
