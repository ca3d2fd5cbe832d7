"""The port's features against the reference, on the same inputs (seeded
numpy): the suite generators, the host featurizer and ``pad_csr_batch``
(identical), the plain versions of the ``entry_stats`` / ``row_stats``
kernels against the reference's Pallas kernels in interpret mode, and the
device featurizer on the CPU against the reference's.

Tolerances: integer statistics (bandwidth, row max/min, counts) match
exactly. Float32 sums (profile, squared deviations, degree means) match to
1e-6 relative: the two packages sum in other orders, and the reference's own
jit and eager featurizers differ in the last float32 bit. Against the
float64 host featurizer, the reference's own 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import features as ref_features  # noqa: E402
from repro.kernels import csr_stats as ref_csr_stats  # noqa: E402
from repro.sparse import dataset as ref_dataset  # noqa: E402

from repro_torch.core import features  # noqa: E402
from repro_torch.kernels import csr_stats  # noqa: E402
from repro_torch.sparse import csr, dataset  # noqa: E402


def _port(a):
    return csr.CSRMatrix(a.indptr, a.indices, a.data, a.shape, a.name,
                         a.group)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.maximum(np.abs(want), 1e-30)


@pytest.fixture(scope="module")
def suite():
    """Reference and port matrices of one seeded suite (all 12 families)."""
    ref = list(ref_dataset.generate_suite(count=12, seed=5, size_scale=0.2))
    port = list(dataset.generate_suite(count=12, seed=5, size_scale=0.2))
    return ref, port


@pytest.mark.parametrize("seed,size_scale", [(0, 0.25), (3, 0.4), (7, 0.15)])
def test_generate_suite_matches_reference(seed, size_scale):
    ref = list(ref_dataset.generate_suite(count=24, seed=seed,
                                          size_scale=size_scale))
    port = list(dataset.generate_suite(count=24, seed=seed,
                                       size_scale=size_scale))
    for a, b in zip(ref, port):
        assert (a.name, a.group, a.shape) == (b.name, b.group, b.shape)
        np.testing.assert_array_equal(b.indptr, a.indptr)
        np.testing.assert_array_equal(b.indices, a.indices)
        np.testing.assert_array_equal(b.data, a.data)
    assert dataset.suite_summary(port) == ref_dataset.suite_summary(ref)
    assert sorted(dataset.GENERATORS) == sorted(ref_dataset.GENERATORS)


def test_host_features_identical(suite, small_suite):
    ref, port = suite
    for a in ref + small_suite:
        b = _port(a)
        np.testing.assert_array_equal(features.extract_features(b),
                                      ref_features.extract_features(a))
        np.testing.assert_array_equal(
            features.extract_features_extended(b),
            ref_features.extract_features_extended(a))
    np.testing.assert_array_equal(features.extract_features_batch(port),
                                  ref_features.extract_features_batch(ref))
    assert features.FEATURE_NAMES == ref_features.FEATURE_NAMES
    assert (features.EXTENDED_FEATURE_NAMES
            == ref_features.EXTENDED_FEATURE_NAMES)


@pytest.mark.parametrize("bucket", [False, True])
def test_pad_csr_batch_identical(suite, bucket):
    ref, port = suite
    got = features.pad_csr_batch(port, bucket=bucket)
    want = ref_features.pad_csr_batch(ref, bucket=bucket)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    got = features.pad_csr_batch(port[:3], n_max=700, nnz_max=5000)
    want = ref_features.pad_csr_batch(ref[:3], n_max=700, nnz_max=5000)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _entry_inputs(rng, B, E, N):
    """(B, E) int32 entries: row 0 all padding (nnz 0), the others with
    random nonzero counts; ``first`` marks entries inside the valid ones."""
    nnz = rng.integers(1, E + 1, B)
    nnz[0] = 0
    rows = rng.integers(0, N, (B, E)).astype(np.int32)
    cols = rng.integers(0, N, (B, E)).astype(np.int32)
    valid = (np.arange(E)[None, :] < nnz[:, None]).astype(np.int32)
    first = (valid & (rng.random((B, E)) < 0.3)).astype(np.int32)
    return rows, cols, valid, first


def _row_inputs(rng, B, N):
    """(B, N) int32 row counts: matrix 0 has n == 0 (no valid row)."""
    n = rng.integers(1, N + 1, B)
    n[0] = 0
    row_nnz = rng.integers(0, 40, (B, N)).astype(np.int32)
    row_valid = (np.arange(N)[None, :] < n[:, None]).astype(np.int32)
    mean = (rng.random(B) * 20).astype(np.float32)
    return row_nnz, row_valid, mean


# E and N not multiples of the reference's 512-wide tiles, and one shape
# spanning several of the port's 4,096-entry chunks
SHAPES = [(3, 700, 90), (5, 1537, 1000), (2, 9000, 5000)]


@pytest.mark.parametrize("B,E,N", SHAPES)
def test_entry_stats_plain_matches_pallas(B, E, N):
    rng = np.random.default_rng(E)
    args = _entry_inputs(rng, B, E, N)
    want = np.asarray(ref_csr_stats.entry_stats(*args, interpret=True))
    got = csr_stats.entry_stats(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32 and got.shape == (B, 2)
    got = got.numpy()
    np.testing.assert_array_equal(got[:, 0], want[:, 0])      # bandwidth
    assert _rel_err(got[:, 1], want[:, 1]).max() <= 1e-6     # profile
    np.testing.assert_array_equal(got[0], [0.0, 0.0])        # all padding


# and for the one-pass row_stats kernel's scalar head and tail: N = 5 and
# N = 1,027 (N % 4 != 0), and B = 1, a single matrix with no valid row
ROW_SHAPES = SHAPES + [(3, 64, 5), (2, 64, 1027), (1, 64, 300)]


@pytest.mark.parametrize("B,E,N", ROW_SHAPES)
def test_row_stats_plain_matches_pallas(B, E, N):
    rng = np.random.default_rng(N)
    args = _row_inputs(rng, B, N)
    want = np.asarray(ref_csr_stats.row_stats(*args, interpret=True))
    got = csr_stats.row_stats(*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32 and got.shape == (B, 3)
    got = got.numpy()
    np.testing.assert_array_equal(got[:, :2], want[:, :2])    # max, min
    if B > 1:
        assert _rel_err(got[1:, 2], want[1:, 2]).max() <= 1e-6  # Σ (x − m)²
    np.testing.assert_array_equal(got[0], want[0])           # n == 0
    assert got[0, 1] == np.float32(csr_stats.ROW_MIN_INIT)


def test_csr_stats_wrappers_take_the_plain_version_only_on_the_cpu():
    rng = np.random.default_rng(0)
    e_args = [torch.from_numpy(a) for a in _entry_inputs(rng, 2, 64, 16)]
    r_args = [torch.from_numpy(a) for a in _row_inputs(rng, 2, 16)]
    before = (csr_stats.entry_stats.launches, csr_stats.row_stats.launches)
    torch.testing.assert_close(csr_stats.entry_stats(*e_args),
                               csr_stats.entry_stats_plain(*e_args))
    torch.testing.assert_close(csr_stats.row_stats(*r_args),
                               csr_stats.row_stats_plain(*r_args))
    # the plain version is no launch
    assert (csr_stats.entry_stats.launches,
            csr_stats.row_stats.launches) == before
    meta = [a.to("meta") for a in e_args]
    with pytest.raises(ValueError, match="CUDA"):
        csr_stats.entry_stats(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        csr_stats.row_stats(r_args[0].to("meta"), *r_args[1:])


@pytest.fixture(scope="module")
def batches(suite):
    ref, port = suite
    return (ref_features.pad_csr_batch(ref, bucket=True),
            features.pad_csr_batch(port, bucket=True))


@pytest.fixture(scope="module")
def ref_batch_features(batches):
    return np.asarray(ref_features.extract_features_batch_jnp(
        batches[0], jit=False, use_pallas=True))


def test_device_featurizer_matches_reference(batches, ref_batch_features):
    got = features.extract_features_batch_device(batches[1], device="cpu")
    assert got.dtype == torch.float32 and got.shape == (12, 12)
    got = got.numpy()
    want = ref_batch_features
    names = features.FEATURE_NAMES
    exact = [names.index(f) for f in (
        "dimension", "nnz", "nnz_max", "nnz_min", "degree_max",
        "degree_min", "bandwidth")]
    np.testing.assert_array_equal(got[:, exact], want[:, exact])
    assert _rel_err(got, want).max() <= 1e-6


def test_device_featurizer_matches_host(suite, batches):
    _, port = suite
    host = features.extract_features_batch(port)
    got = features.extract_features_batch_device(batches[1],
                                                 device="cpu").numpy()
    np.testing.assert_allclose(got, host, rtol=1e-4)


def test_device_featurizer_bucketed_padding_invariant(suite, batches):
    """Extra pow2 padding must not change any feature value."""
    _, port = suite
    tight = features.extract_features_batch_device(
        features.pad_csr_batch(port), device="cpu").numpy()
    padded = features.extract_features_batch_device(
        batches[1], device="cpu").numpy()
    np.testing.assert_allclose(padded, tight, rtol=1e-6)


def test_csr_stats_args_are_what_the_featurizer_reduces(batches):
    """The kernels' arguments as the featurizer builds them: int32, and the
    stats computed from them are the featurizer's bandwidth, profile,
    nnz_max and nnz_min."""
    (ea, ra) = features.csr_stats_args(batches[1], device="cpu")
    assert all(t.dtype == torch.int32 for t in ea + ra[:2])
    assert ra[2].dtype == torch.float32
    es = csr_stats.entry_stats(*ea).numpy()
    rs = csr_stats.row_stats(*ra).numpy()
    f = features.extract_features_batch_device(batches[1],
                                               device="cpu").numpy()
    names = features.FEATURE_NAMES
    np.testing.assert_array_equal(es[:, 0], f[:, names.index("bandwidth")])
    np.testing.assert_array_equal(es[:, 1], f[:, names.index("profile")])
    np.testing.assert_array_equal(rs[:, 0], f[:, names.index("nnz_max")])
    np.testing.assert_array_equal(rs[:, 1], f[:, names.index("nnz_min")])


def test_device_featurizer_needs_a_card_unless_asked_for_the_cpu(batches):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        features.extract_features_batch_device(batches[1])


def test_device_featurizer_reduces_through_the_kernel_wrappers(batches,
                                                               monkeypatch):
    """Each featurizer call hands its reductions to the ``entry_stats`` /
    ``row_stats`` wrappers once, with the arguments ``csr_stats_args``
    builds: there is no route to the plain reductions that bypasses the
    wrappers (which launch the kernels on a card)."""
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append((name, args))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(features, "entry_stats",
                        spy("entry_stats", csr_stats.entry_stats))
    monkeypatch.setattr(features, "row_stats",
                        spy("row_stats", csr_stats.row_stats))
    features.extract_features_batch_device(batches[1], device="cpu")
    assert [name for name, _ in calls] == ["entry_stats", "row_stats"]
    ea, ra = features.csr_stats_args(batches[1], device="cpu")
    for (_, got), want in zip(calls, (ea, ra)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_feature_sets_registered_like_the_reference():
    from repro.engine.registry import get_feature_set as ref_get
    from repro_torch.engine.registry import get_feature_set

    for name in ("paper12", "extended19"):
        fs, ref = get_feature_set(name), ref_get(name)
        assert list(fs.names) == list(ref.names) and fs.dim == ref.dim
    assert get_feature_set("paper12").device_capable
    assert not get_feature_set("extended19").device_capable
    assert (get_feature_set("paper12").extract_batch_device
            is features.extract_features_batch_device)


@pytest.mark.parametrize("name", ["bandwidth", "profile"])
def test_bandwidth_and_profile_identical(small_suite, suite, name):
    from repro.sparse import csr as ref_csr

    for a in small_suite + suite[0]:
        assert getattr(csr, name)(_port(a)) == getattr(ref_csr, name)(a)
