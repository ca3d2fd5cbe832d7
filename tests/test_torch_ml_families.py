"""Fig. 4's seven model families in the port against the reference, on a
seeded 4-class, 12-feature set (numpy) and on the tracked 12-matrix label
set, all on the CPU.

Tolerances: weights carried across from the reference give the same argmax
and class scores within 1e-5 relative (float32 products on both sides);
logistic regression trained by both packages from the same zero init lands
within 1e-4 relative; the MLP trained from the reference's own initial
weights within 1e-3 relative (Adam over float32 sums in a different order);
SVM and MLP trained from the port's own seeded draws reach held-out accuracy
at least the reference's minus 0.05. KNN and naive Bayes are float64 host
copies and agree to 1e-12.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ml as ref_ml  # noqa: E402
from repro.core.ml import jax_models as ref_jm  # noqa: E402
from repro.core.scaling import StandardScaler as RefScaler  # noqa: E402
from repro.core.selector import ReorderSelector as RefSelector  # noqa: E402
from repro.engine.bundle import SelectorBundle as RefBundle  # noqa: E402
from repro.engine.core import SolverEngine as RefEngine  # noqa: E402
from repro.engine.fingerprint import component_fingerprint as ref_fp  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import ml  # noqa: E402
from repro_torch.core.labeling import LabeledDataset  # noqa: E402
from repro_torch.core.ml import torch_models as jm  # noqa: E402
from repro_torch.core.scaling import StandardScaler  # noqa: E402
from repro_torch.core.selector import ReorderSelector  # noqa: E402
from repro_torch.engine import EngineConfig, SolverEngine  # noqa: E402
from repro_torch.engine.bundle import SelectorBundle  # noqa: E402
from repro_torch.engine.fingerprint import component_fingerprint  # noqa: E402
from repro_torch.sparse.dataset import generate_suite  # noqa: E402

LABELS_C12 = "artifacts/labels_c12_s7_x0.25_r1.npz"
FAMILIES = ["random_forest", "decision_tree", "logistic_regression",
            "naive_bayes", "svm", "mlp", "knn"]
NEW_FAMILIES = ["logistic_regression", "svm", "mlp", "knn", "naive_bayes"]
# reduced steps where a case checks parity only
DIFFERENTIABLE = [
    ("LogisticRegression", dict(steps=120)),
    ("SVMClassifier", dict(steps=120)),
    ("SVMClassifier", dict(steps=120, kernel="linear")),
    ("MLPClassifier", dict(steps=120)),
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Training here is thousands of tiny CPU ops: one intra-op thread runs
    them fastest, and keeps parallel test workers from oversubscribing."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def blobs():
    """Standardized 4-class, 12-feature Gaussian blobs: 600 train, 200
    held out."""
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(4, 12)) * 0.9
    y = rng.integers(0, 4, 800)
    x = centers[y] + rng.normal(size=(800, 12))
    x = (x - x[:600].mean(0)) / x[:600].std(0)
    return x[:600], y[:600], x[600:], y[600:]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _scores(model, x):
    """Class scores of a port model (``forward_device`` on CPU tensors) or
    a reference one (``forward_jnp``)."""
    if hasattr(model, "forward_device"):
        return model.forward_device(
            torch.from_numpy(x.astype(np.float32))).numpy()
    return np.asarray(model.forward_jnp(jnp.asarray(x, jnp.float32)))


def test_zoo_holds_all_seven_families_with_the_references_flags():
    assert sorted(ml.MODEL_ZOO) == sorted(FAMILIES) == sorted(ref_ml.MODEL_ZOO)
    for name in FAMILIES:
        assert (ml.MODEL_ZOO.metadata(name)["device_capable"]
                == ref_ml.MODEL_ZOO.metadata(name)["device_capable"]), name
        want = ref_ml.MODEL_ZOO[name]().params
        assert ml.MODEL_ZOO[name]().params == want, name


@pytest.mark.parametrize("cls,kw", DIFFERENTIABLE,
                         ids=["lr", "svm_rbf", "svm_linear", "mlp"])
def test_weights_carried_across_predict_the_same(blobs, cls, kw):
    xtr, ytr, xte, _ = blobs
    ref = getattr(ref_jm, cls)(**kw).fit(xtr, ytr)
    state = convert.classifier_state_arrays(ref.state())
    port = getattr(jm, cls)(**kw).load_state(state)
    assert component_fingerprint(port) == ref_fp(ref)
    x = np.concatenate([xtr, xte])
    np.testing.assert_array_equal(port.predict(x), ref.predict(x))
    assert _rel(_scores(port, x), _scores(ref, x)) <= 1e-5
    if hasattr(ref, "predict_proba"):
        assert _rel(port.predict_proba(x), ref.predict_proba(x)) <= 1e-5


@pytest.mark.parametrize("cls,kw", DIFFERENTIABLE,
                         ids=["lr", "svm_rbf", "svm_linear", "mlp"])
def test_fitted_state_is_numpy_under_the_references_keys(blobs, cls, kw):
    xtr, ytr, _, _ = blobs
    kw = dict(kw, steps=5)
    ref = getattr(ref_jm, cls)(**kw).fit(xtr, ytr)
    port = getattr(jm, cls)(**kw).fit(xtr, ytr, device="cpu")
    st, ref_st = port.state(), ref.state()
    assert sorted(st) == sorted(ref_st)
    leaves = jax.tree_util.tree_leaves({k: v for k, v in st.items()
                                        if k != "n_classes_"})
    ref_leaves = jax.tree_util.tree_leaves(
        {k: v for k, v in ref_st.items() if k != "n_classes_"})
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        assert a.shape == b.shape
    assert st["n_classes_"] == ref_st["n_classes_"] == 4
    # the fingerprint hashes the numpy state and survives a round trip
    again = getattr(jm, cls)(**kw).load_state(st)
    assert component_fingerprint(again) == component_fingerprint(port)


def test_logistic_regression_training_matches_reference(blobs):
    xtr, ytr, xte, _ = blobs
    ref = ref_jm.LogisticRegression().fit(xtr, ytr)
    port = jm.LogisticRegression().fit(xtr, ytr, device="cpu")
    assert _rel(port.w_, ref.w_) <= 1e-4
    assert _rel(port.b_, ref.b_) <= 1e-4
    np.testing.assert_array_equal(port.predict(xte), ref.predict(xte))


def test_mlp_training_from_the_references_init_matches(blobs, monkeypatch):
    xtr, ytr, _, _ = blobs
    kw = dict(steps=100, random_state=1)

    def ref_init(sizes, random_state):
        # the reference's draws (repro.core.ml.jax_models.MLPClassifier.fit)
        key = jax.random.PRNGKey(random_state)
        out = []
        for i in range(len(sizes) - 1):
            key, sub = jax.random.split(key)
            w = jnp.sqrt(2.0 / sizes[i]) * jax.random.normal(
                sub, (sizes[i], sizes[i + 1]))
            out.append((torch.from_numpy(np.array(w)),
                        torch.zeros((sizes[i + 1],), dtype=torch.float32)))
        return out

    monkeypatch.setattr(jm, "_mlp_init", ref_init)
    ref = ref_jm.MLPClassifier(**kw).fit(xtr, ytr)
    port = jm.MLPClassifier(**kw).fit(xtr, ytr, device="cpu")
    for (w, b), (rw, rb) in zip(port.params_, ref.params_):
        assert _rel(w, rw) <= 1e-3
        assert _rel(b, rb) <= 1e-3


@pytest.mark.parametrize("cls", ["SVMClassifier", "MLPClassifier"])
def test_own_seed_training_reaches_the_references_accuracy(blobs, cls):
    xtr, ytr, xte, yte = blobs
    for seed in (0, 1):
        ref = getattr(ref_jm, cls)(random_state=seed).fit(xtr, ytr)
        port = getattr(jm, cls)(random_state=seed).fit(xtr, ytr,
                                                       device="cpu")
        ref_acc = float((ref.predict(xte) == yte).mean())
        acc = float((port.predict(xte) == yte).mean())
        assert acc >= ref_acc - 0.05, (seed, acc, ref_acc)


def test_same_seed_draws_the_same_start_on_any_device():
    g1 = jm._mlp_init([12, 8, 4], 5)
    g2 = jm._mlp_init([12, 8, 4], 5)
    for (w1, b1), (w2, b2) in zip(g1, g2):
        assert torch.equal(w1, w2) and torch.equal(b1, b2)


def test_fit_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    x = np.zeros((4, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        jm.LogisticRegression(steps=1).fit(x, np.array([0, 1, 0, 1]))


@pytest.mark.parametrize("metric", ["euclidean", "manhattan"])
@pytest.mark.parametrize("weights", ["uniform", "distance"])
def test_knn_matches_reference(blobs, weights, metric):
    xtr, ytr, xte, _ = blobs
    kw = dict(n_neighbors=5, weights=weights, metric=metric)
    ref = ref_ml.KNeighborsClassifier(**kw).fit(xtr, ytr)
    port = ml.KNeighborsClassifier(**kw).fit(xtr, ytr)
    np.testing.assert_allclose(port.predict_proba(xte),
                               ref.predict_proba(xte), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(port.predict(xte), ref.predict(xte))
    assert component_fingerprint(port) == ref_fp(ref)


@pytest.mark.parametrize("var_smoothing", [1e-9, 1e-6])
def test_naive_bayes_matches_reference(blobs, var_smoothing):
    xtr, ytr, xte, _ = blobs
    ref = ref_ml.GaussianNB(var_smoothing).fit(xtr, ytr)
    port = ml.GaussianNB(var_smoothing).fit(xtr, ytr)
    np.testing.assert_allclose(port.predict_proba(xte),
                               ref.predict_proba(xte), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(port.predict(xte), ref.predict(xte))
    assert component_fingerprint(port) == ref_fp(ref)


@pytest.fixture(scope="module")
def label_set():
    ds = LabeledDataset.load(LABELS_C12)
    mats = list(generate_suite(12, seed=7, size_scale=0.25))
    return ds, mats


def _ref_model(name):
    kw = {"logistic_regression": dict(steps=150), "svm": dict(steps=150),
          "mlp": dict(steps=150), "random_forest": dict(n_estimators=10)}
    return ref_ml.MODEL_ZOO[name](**kw.get(name, {}))


@pytest.mark.parametrize("name", FAMILIES)
def test_reference_bundles_convert_and_select_the_same(label_set, name,
                                                       tmp_path):
    ds, mats = label_set
    scaler = RefScaler().fit(ds.features)
    model = _ref_model(name).fit(scaler.transform(ds.features), ds.labels)
    ref_sel = RefSelector(model, scaler, list(ds.algorithms))
    ref_bundle = RefBundle.from_selector(ref_sel)
    bundle = convert.bundle_from_arrays(
        **convert.selector_bundle_arrays(ref_bundle))
    assert bundle.fingerprint == ref_bundle.fingerprint
    path = bundle.save(str(tmp_path / f"{name}.bundle"))
    loaded = SelectorBundle.load(path)
    assert loaded.fingerprint == ref_bundle.fingerprint
    sel = loaded.to_selector()
    want, _ = ref_sel.select_batch(mats, path="host")
    assert sel.select_batch(mats, path="host")[0] == want
    assert sel.select_batch(mats, path="device", device="cpu")[0] == want
    assert sel.accuracy(ds.features, ds.labels) == \
        ref_sel.accuracy(ds.features, ds.labels)


@pytest.mark.parametrize("name", NEW_FAMILIES)
def test_engine_trains_each_new_family(label_set, name, tmp_path):
    ds, mats = label_set
    eng = SolverEngine(EngineConfig(model=name, fast_grids=True, cv=3,
                                    device="cpu"))
    rep = eng.train(ds)
    assert 0.0 <= rep["test_accuracy"] <= 1.0
    names = eng.select_batch(mats)
    assert set(names) <= set(ds.algorithms)
    assert names == eng.selector.select_batch(mats, path="host")[0]
    path = eng.save(str(tmp_path / "sel.bundle"))
    again = SolverEngine.load(path, EngineConfig(device="cpu"))
    assert again.fingerprint == eng.fingerprint
    assert again.select_batch(mats) == names


def test_accuracy_is_trained_and_feature_set_match_reference(label_set):
    ds, _ = label_set
    scaler, ref_scaler = StandardScaler().fit(ds.features), \
        RefScaler().fit(ds.features)
    xs = scaler.transform(ds.features)
    model = ml.GaussianNB().fit(xs, ds.labels)
    ref_model = ref_ml.GaussianNB().fit(xs, ds.labels)
    sel = ReorderSelector(model, scaler, list(ds.algorithms))
    ref_sel = RefSelector(ref_model, ref_scaler, list(ds.algorithms))
    assert sel.accuracy(ds.features, ds.labels) == \
        ref_sel.accuracy(ds.features, ds.labels)
    eng, ref_eng = SolverEngine(EngineConfig(device="cpu")), RefEngine()
    assert eng.is_trained is ref_eng.is_trained is False
    eng.attach(sel)
    ref_eng.attach(ref_sel)
    assert eng.is_trained is ref_eng.is_trained is True
    fs, ref_fs = eng.feature_set(), ref_eng.feature_set()
    assert (fs.name, list(fs.names), fs.dim) == \
        (ref_fs.name, list(ref_fs.names), ref_fs.dim)
