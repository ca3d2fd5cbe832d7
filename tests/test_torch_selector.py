"""The port's selector against the reference on the same data (the tracked
label sets under ``artifacts/``, and seeded numpy): scalers, splits and
grid search, trees and forests (identical node arrays), forest inference on
tensors against ``forest_forward_jnp``, fingerprints, selector bundles
across the two packages, and ``train_selector``.

Tolerances: host training and float64 transforms are identical. Forest
probabilities are float32 on both sides and match to 1e-6 with identical
argmax; the float32 scaler transform matches to 1e-6 relative.
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import model_selection as ref_ms  # noqa: E402
from repro.core import scaling as ref_scaling  # noqa: E402
from repro.core.labeling import LabeledDataset as RefDataset  # noqa: E402
from repro.core.ml import DecisionTreeClassifier as RefTree  # noqa: E402
from repro.core.ml import RandomForestClassifier as RefForest  # noqa: E402
from repro.core.ml.forest_jnp import forest_forward_jnp  # noqa: E402
from repro.core.selector import FAST_GRIDS as REF_FAST_GRIDS  # noqa: E402
from repro.core.selector import DEFAULT_GRIDS as REF_GRIDS  # noqa: E402
from repro.core.selector import scaler_transform_jnp  # noqa: E402
from repro.core.selector import train_selector as ref_train  # noqa: E402
from repro.engine import fingerprint as ref_fp  # noqa: E402
from repro.engine.bundle import SelectorBundle as RefBundle  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import model_selection as ms  # noqa: E402
from repro_torch.core import scaling  # noqa: E402
from repro_torch.core.labeling import LabeledDataset  # noqa: E402
from repro_torch.core.ml import (MODEL_ZOO, DecisionTreeClassifier,  # noqa: E402
                                 RandomForestClassifier)
from repro_torch.core.ml.forest_torch import (forest_forward_device,  # noqa: E402
                                              forest_to_arrays)
from repro_torch.core.selector import (DEFAULT_GRIDS, FAST_GRIDS,  # noqa: E402
                                       ReorderSelector, train_selector)
from repro_torch.engine import fingerprint as fp  # noqa: E402
from repro_torch.engine.bundle import (BundleValidationError,  # noqa: E402
                                       SelectorBundle)
from repro_torch.engine.registry import (DuplicateNameError,  # noqa: E402
                                         Registry, RegistryLookupError)

LABELS_C12 = "artifacts/labels_c12_s7_x0.25_r1.npz"


@pytest.fixture(scope="module")
def data():
    """Standardized features and labels of the 12-matrix label set."""
    ds = LabeledDataset.load(LABELS_C12)
    x = scaling.StandardScaler().fit_transform(ds.features)
    return x, ds.labels


def _assert_state_equal(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_state_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_state_equal(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_labeled_dataset_load_and_save_round_trip(tmp_path):
    ds = LabeledDataset.load(LABELS_C12)
    ref = RefDataset.load(LABELS_C12)
    for f in ("features", "labels", "times", "order_times", "fills",
              "flops", "dims", "nnzs"):
        np.testing.assert_array_equal(getattr(ds, f), getattr(ref, f))
    assert (ds.names, ds.groups, ds.algorithms, ds.feature_set) == (
        ref.names, ref.groups, ref.algorithms, ref.feature_set)
    path = str(tmp_path / "labels.npz")
    ds.save(path)
    back = RefDataset.load(path)  # the port's file reads in the reference
    np.testing.assert_array_equal(back.features, ds.features)
    assert back.algorithms == ds.algorithms


@pytest.mark.parametrize("name", ["none", "minmax", "standard"])
def test_scalers_match_reference(data, name):
    ds = LabeledDataset.load(LABELS_C12)
    s = scaling.SCALERS[name]().fit(ds.features)
    r = ref_scaling.SCALERS[name]().fit(ds.features)
    np.testing.assert_array_equal(s.transform(ds.features),
                                  r.transform(ds.features))
    _assert_state_equal(s.state(), r.state())
    assert s.fingerprint() == r.fingerprint()
    x32 = ds.features.astype(np.float32)
    got = scaling.scaler_transform_device(s, torch.from_numpy(x32)).numpy()
    want = np.asarray(scaler_transform_jnp(r, x32))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_scaler_device_state_is_cached_per_fit():
    rng = np.random.default_rng(0)
    s = scaling.StandardScaler().fit(rng.random((8, 3)))
    x = torch.ones((2, 3))
    scaling.scaler_transform_device(s, x)
    first = s._device_state
    scaling.scaler_transform_device(s, x)
    assert s._device_state is first            # warm: nothing re-uploaded
    s.fit(rng.random((8, 3)) + 5)
    got = scaling.scaler_transform_device(s, x)
    assert s._device_state is not first        # refit: new state
    np.testing.assert_allclose(got.numpy(), s.transform(np.ones((2, 3))),
                               rtol=1e-6)


def test_splits_match_reference(data):
    x, y = data
    for stratify in (True, False):
        got = ms.train_test_split(x, y, 0.25, 3, stratify)
        want = ref_ms.train_test_split(x, y, 0.25, 3, stratify)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for (gt, gv), (wt, wv) in zip(ms.kfold_indices(12, 3, 1),
                                  ref_ms.kfold_indices(12, 3, 1)):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gv, wv)


def test_grid_search_matches_reference(data):
    x, y = data
    grid = {"criterion": ["gini", "entropy"], "max_depth": [None, 2]}
    got = ms.GridSearchCV(DecisionTreeClassifier(), grid, cv=3).fit(x, y)
    want = ref_ms.GridSearchCV(RefTree(), grid, cv=3).fit(x, y)
    assert got.best_params_ == want.best_params_
    assert got.best_score_ == want.best_score_
    assert got.results_ == want.results_
    _assert_state_equal(got.best_model_.state(), want.best_model_.state())


TREE_PARAMS = [dict(), dict(criterion="entropy", max_depth=3),
               dict(min_samples_leaf=2, max_features="sqrt", random_state=4)]
FOREST_PARAMS = [dict(n_estimators=10), dict(n_estimators=7, bootstrap=False,
                                             min_samples_split=4,
                                             random_state=3)]


@pytest.mark.parametrize("params", TREE_PARAMS)
def test_tree_fit_identical_to_reference(data, params):
    x, y = data
    got = DecisionTreeClassifier(**params).fit(x, y)
    want = RefTree(**params).fit(x, y)
    _assert_state_equal(got.state(), want.state())
    assert got.fingerprint() == want.fingerprint()
    np.testing.assert_array_equal(got.predict_proba(x),
                                  want.predict_proba(x))


@pytest.mark.parametrize("params", FOREST_PARAMS)
def test_forest_fit_identical_to_reference(data, params):
    x, y = data
    got = RandomForestClassifier(**params).fit(x, y)
    want = RefForest(**params).fit(x, y)
    _assert_state_equal(got.state(), want.state())
    assert got.fingerprint() == want.fingerprint()
    np.testing.assert_array_equal(got.predict_proba(x),
                                  want.predict_proba(x))
    # load_state rebuilds the same trees
    back = RandomForestClassifier(**params).load_state(got.state())
    np.testing.assert_array_equal(back.predict(x), got.predict(x))


@pytest.mark.parametrize("family", ["tree", "forest"])
def test_forest_forward_matches_forest_forward_jnp(data, family):
    x, y = data
    rng = np.random.default_rng(1)
    # training rows plus seeded points between them
    xq = np.concatenate([x, x[rng.integers(0, len(x), 20)]
                         + 0.3 * rng.standard_normal((20, x.shape[1]))])
    if family == "tree":
        model, trees = DecisionTreeClassifier().fit(x, y), None
    else:
        model = RandomForestClassifier(n_estimators=12).fit(x, y)
        trees = model.trees_
    fa = forest_to_arrays(trees or [model], int(model.n_classes_))
    want = np.asarray(forest_forward_jnp(fa, xq.astype(np.float32)))
    got = model.forward_device(torch.from_numpy(xq.astype(np.float32)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_array_equal(got.argmax(1).numpy(), want.argmax(1))
    np.testing.assert_array_equal(
        forest_forward_device(fa, torch.from_numpy(xq)).numpy(), got.numpy())
    np.testing.assert_array_equal(got.argmax(1).numpy(), model.predict(xq))


def test_forest_tensors_uploaded_once_per_fit(data):
    x, y = data
    model = RandomForestClassifier(n_estimators=5).fit(x, y)
    xt = torch.from_numpy(x.astype(np.float32))
    model.forward_device(xt)
    key, fa, per_device = model._flat
    tensors = per_device[xt.device]
    model.forward_device(xt)
    assert model._flat[2][xt.device] is tensors  # warm: nothing uploaded
    model.fit(x[::-1].copy(), y[::-1].copy())
    model.forward_device(xt)
    assert model._flat[0] is not key             # refit: rebuilt


def test_fingerprints_match_reference():
    rng = np.random.default_rng(2)
    state = {"a": rng.random((3, 2)), "b": [1, 2.5, "x", None, b"y"],
             "c": {"n": np.int32(4), "t": (True, np.float64(0.1))}}
    assert fp.fingerprint_state(state) == ref_fp.fingerprint_state(state)
    assert fp.combine_fingerprints(m="1", s="2") == \
        ref_fp.combine_fingerprints(m="1", s="2")


def test_grids_are_the_references():
    from repro.core.ml import MODEL_ZOO as REF_ZOO
    assert DEFAULT_GRIDS == REF_GRIDS
    assert FAST_GRIDS == REF_FAST_GRIDS
    assert sorted(MODEL_ZOO) == sorted(REF_ZOO)
    for m in REF_ZOO:
        assert (MODEL_ZOO.metadata(m)["device_capable"]
                == REF_ZOO.metadata(m)["device_capable"])


@pytest.fixture(scope="module")
def trained():
    """The same selector trained by both packages on the 12-matrix set."""
    ds, ref_ds = LabeledDataset.load(LABELS_C12), RefDataset.load(LABELS_C12)
    kw = dict(fast=True, cv=3)
    return train_selector(ds, **kw), ref_train(ref_ds, **kw)


def test_train_selector_matches_reference(trained):
    (sel, rep), (ref_sel, ref_rep) = trained
    for k in ("best_params", "cv_score", "test_accuracy", "time_amd",
              "time_predicted", "time_ideal", "per_algorithm_recall",
              "test_support", "mean_speedup_vs_amd"):
        assert rep[k] == ref_rep[k], k
    for k in ("confusion", "test_idx", "train_idx", "predictions"):
        np.testing.assert_array_equal(rep[k], ref_rep[k])
    _assert_state_equal(sel.model.state(), ref_sel.model.state())
    assert isinstance(sel, ReorderSelector)


def test_bundle_fingerprint_matches_reference(trained):
    (sel, _), (ref_sel, _) = trained
    got = SelectorBundle.from_selector(sel)
    want = RefBundle.from_selector(ref_sel)
    assert got.fingerprint == want.fingerprint
    assert got.compute_fingerprint() == want.compute_fingerprint()


def test_reference_bundle_loads_in_the_port(trained, tmp_path):
    (sel, _), (ref_sel, _) = trained
    path = str(tmp_path / "ref.bundle")
    RefBundle.from_selector(ref_sel, report_card={"test_accuracy": 0.5},
                            provenance={"n_samples": 12}).save(path)
    b = SelectorBundle.load(path)
    assert b.fingerprint == RefBundle.load(path).fingerprint
    assert b.report_card == {"test_accuracy": 0.5}
    x = LabeledDataset.load(LABELS_C12).features
    np.testing.assert_array_equal(b.to_selector().predict_features(x),
                                  ref_sel.predict_features(x))


def test_port_bundle_loads_in_the_reference(trained, tmp_path):
    (sel, _), (ref_sel, _) = trained
    path = str(tmp_path / "port.bundle")
    SelectorBundle.from_selector(sel).save(path)
    b = RefBundle.load(path)
    assert b.fingerprint == SelectorBundle.load(path).fingerprint
    x = LabeledDataset.load(LABELS_C12).features
    np.testing.assert_array_equal(b.to_selector().predict_features(x),
                                  sel.predict_features(x))


def test_bundle_carried_across_as_plain_data(trained):
    (_, _), (ref_sel, _) = trained
    ref_b = RefBundle.from_selector(ref_sel)
    b = convert.bundle_from_arrays(**convert.selector_bundle_arrays(ref_b))
    assert isinstance(b, SelectorBundle)
    assert b.fingerprint == ref_b.fingerprint == b.compute_fingerprint()
    back = RefBundle(**convert.selector_bundle_arrays(b)).validate()
    assert back.fingerprint == ref_b.fingerprint


def test_bundle_validation_refuses_what_it_cannot_serve(trained, tmp_path):
    (sel, _), _ = trained
    b = SelectorBundle.from_selector(sel)
    fields = convert.selector_bundle_arrays(b)
    with pytest.raises(BundleValidationError, match="fingerprint"):
        SelectorBundle(**dict(fields, algorithms=["rcm", "nd", "amd",
                                                  "scotch"])).validate()
    with pytest.raises(BundleValidationError, match="unknown model"):
        SelectorBundle(**dict(fields, model_name="gradient_boosting",
                              fingerprint="")).validate()
    with pytest.raises(BundleValidationError, match="feature schema"):
        SelectorBundle(**dict(fields, feature_names=["n"],
                              fingerprint="")).validate()
    with pytest.raises(BundleValidationError, match="newer"):
        SelectorBundle(**dict(fields, schema_version=99)).validate()
    path = tmp_path / "raw.pkl"
    path.write_bytes(pickle.dumps({"not": "a bundle"}))
    with pytest.raises(BundleValidationError, match="not a SelectorBundle"):
        SelectorBundle.load(str(path))


def test_registry_errors_suggest_names():
    reg = Registry("widget")
    reg.register("alpha", object())
    with pytest.raises(DuplicateNameError):
        reg.register("alpha", object())
    with pytest.raises(RegistryLookupError, match="did you mean 'alpha'"):
        reg["alpah"]
    with pytest.raises(KeyError):
        MODEL_ZOO["random_forrest"]


def test_selector_batch_paths_agree(trained):
    (sel, _), _ = trained
    from repro_torch.sparse.dataset import generate_suite

    mats = list(generate_suite(count=12, seed=9, size_scale=0.2))
    host, _ = sel.select_batch(mats, path="host")
    dev, _ = sel.select_batch(mats, path="device", device="cpu")
    assert dev == host
    assert [sel.select(a)[0] for a in mats] == host
