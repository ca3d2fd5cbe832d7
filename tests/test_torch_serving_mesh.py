"""The selector's serving mesh on the CPU: a served batch split over 1–4
shards of the host device (``make_serving_mesh(n, "cpu")``, the port's
counterpart of the reference's forced host devices).

* For widths 1–4 and B ∈ {1, 2, 3, 5, 7, 8, 13} of
  ``generate_suite(13, seed=3, size_scale=0.25)``: the features are the
  same bits at every width, and within 1e-6 relative of the reference's
  one-device ``extract_features_batch_jnp`` (the reference's own
  multi-device test fails on this tree, so it is not the oracle); the
  names of a random forest of 8 trees equal the reference selector's.
* Each shard hands ``entry_stats`` and ``row_stats`` one call, with the
  arguments ``csr_stats_shard_args`` gives.
* ``EngineConfig(device="cpu", serving_devices=4)`` through ``serve()``
  plans every matrix; a warm ``plan_batch`` returns the same
  fingerprints; the per-shard counters follow the reference's
  ``shard_utilization`` arithmetic.
* ``make_serving_mesh`` raises for 0 shards and for more cards than
  exist."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.features import \
    extract_features_batch_jnp as ref_features  # noqa: E402
from repro.core.features import pad_csr_batch as ref_pad  # noqa: E402
from repro.core.metrics import MetricsRegistry as RefRegistry  # noqa: E402
from repro.core.ml import RandomForestClassifier as RefForest  # noqa: E402
from repro.core.scaling import StandardScaler as RefScaler  # noqa: E402
from repro.core.selector import ReorderSelector as RefSelector  # noqa: E402
from repro.distributed import meshctx as ref_meshctx  # noqa: E402
from repro.sparse.dataset import generate_suite as ref_suite  # noqa: E402

from repro_torch.core import features  # noqa: E402
from repro_torch.core.features import (FEATURE_NAMES,  # noqa: E402
                                       csr_stats_shard_args,
                                       extract_features_batch,
                                       extract_features_batch_device,
                                       pad_csr_batch)
from repro_torch.core.metrics import MetricsRegistry  # noqa: E402
from repro_torch.core.ml import RandomForestClassifier  # noqa: E402
from repro_torch.core.scaling import StandardScaler  # noqa: E402
from repro_torch.core.selector import ReorderSelector  # noqa: E402
from repro_torch.distributed import meshctx  # noqa: E402
from repro_torch.engine import EngineConfig, SolverEngine  # noqa: E402
from repro_torch.sparse.dataset import generate_suite  # noqa: E402

SUITE = dict(count=13, seed=3, size_scale=0.25)
WIDTHS = (1, 2, 3, 4)
SIZES = (1, 2, 3, 5, 7, 8, 13)
T = 60.0


@pytest.fixture(scope="module")
def mats():
    return list(generate_suite(**SUITE)), list(ref_suite(**SUITE))


@pytest.fixture(scope="module")
def selectors(mats):
    """The reference's test selector, fitted in both packages on the same
    features and labels (the forests fit the same trees)."""
    port, ref = mats
    feats = extract_features_batch(port)
    labels = (feats[:, FEATURE_NAMES.index("bandwidth")]
              / np.maximum(feats[:, 0], 1) > 0.5).astype(int)
    labels[:3] = 1 - labels[:3]  # both classes, whatever the suite holds
    scaler, rscaler = StandardScaler().fit(feats), RefScaler().fit(feats)
    rf = RandomForestClassifier(n_estimators=8).fit(
        scaler.transform(feats), labels)
    rrf = RefForest(n_estimators=8).fit(rscaler.transform(feats), labels)
    return (ReorderSelector(rf, scaler, ["amd", "rcm"]),
            RefSelector(rrf, rscaler, ["amd", "rcm"]))


@pytest.fixture(autouse=True)
def no_installed_mesh():
    meshctx.set_serving_mesh(None)
    yield
    meshctx.set_serving_mesh(None)


@pytest.mark.parametrize("b", SIZES)
def test_features_are_the_same_bits_at_every_width(mats, b):
    port, ref = mats
    batch = pad_csr_batch(port[:b], bucket=True)
    one = extract_features_batch_device(
        batch, device="cpu", mesh=meshctx.make_serving_mesh(1, "cpu"))
    assert one.shape == (b, 12)
    for w in WIDTHS[1:]:
        got = extract_features_batch_device(
            batch, device="cpu", mesh=meshctx.make_serving_mesh(w, "cpu"))
        assert torch.equal(got, one), w
    want = np.asarray(ref_features(ref_pad(ref[:b], bucket=True),
                                   mesh=ref_meshctx.make_serving_mesh(1)))
    np.testing.assert_allclose(one.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("width", WIDTHS)
def test_names_over_the_mesh_equal_the_reference(mats, selectors, width):
    port, ref = mats
    sel, rsel = selectors
    with meshctx.serving_mesh(meshctx.make_serving_mesh(width, "cpu")):
        for b in SIZES:
            got, _ = sel.select_batch(port[:b], path="device", device="cpu")
            want, _ = rsel.select_batch(ref[:b], path="device")
            assert got == want, b
    assert meshctx.installed_serving_mesh() is None


@pytest.mark.parametrize("width", [2, 3])
def test_each_shard_calls_the_two_kernels_once(mats, monkeypatch, width):
    batch = pad_csr_batch(mats[0][:7], bucket=True)
    sm = meshctx.make_serving_mesh(width, "cpu")
    calls = {"entry": [], "row": []}
    for name, key in (("entry_stats", "entry"), ("row_stats", "row")):
        real = getattr(features, name)

        def rec(*args, real=real, key=key):
            calls[key].append(args)
            return real(*args)

        monkeypatch.setattr(features, name, rec)
    extract_features_batch_device(batch, device="cpu", mesh=sm)
    want = csr_stats_shard_args(batch, sm)
    assert len(calls["entry"]) == len(calls["row"]) == width == len(want)
    for (ea, ra), e, r in zip(want, calls["entry"], calls["row"]):
        assert all(torch.equal(x, y) for x, y in zip(ea, e))
        assert all(torch.equal(x, y) for x, y in zip(ra, r))
        # every shard keeps the padded N and E; 7 rows pad to a multiple
        assert ea[0].shape == (-(-7 // width), batch.indices.shape[1])
        assert ra[0].shape[1] == batch.indptr.shape[1] - 1


def test_engine_serves_over_four_cpu_shards(mats, selectors):
    port, _ = mats
    eng = SolverEngine(EngineConfig(device="cpu", serving_devices=4,
                                    batch_size=6), selector=selectors[0])
    server = eng.serve()
    try:
        plans = [server.submit(a).result(timeout=T) for a in port]
    finally:
        server.close(timeout=T)
    assert meshctx.get_serving_mesh("cpu").num_devices == 4
    assert [p.fingerprint for p in plans] == [
        p.fingerprint for p in eng.plan_batch(port)]  # warm: the cache
    one, _ = selectors[0].select_batch(port, path="device", device="cpu")
    assert [p.algorithm for p in plans] == one
    snap = eng.metrics.snapshot()
    assert snap["mesh.shards"] == 4
    served = sum(snap[f"mesh.shard{i}.requests"] for i in range(4))
    assert served == snap["infer.matrices"] == len(port)


def _ref_mesh(width: int):
    """A reference ``ServingMesh`` of ``width`` shards: its arithmetic reads
    only the device array's shape."""
    return ref_meshctx.ServingMesh(types.SimpleNamespace(
        devices=np.empty((width,), object)))


@pytest.mark.parametrize("width", [2, 3, 4])
def test_shard_utilization_counts_match_the_reference(width):
    got, want = MetricsRegistry(), RefRegistry()
    sm = meshctx.make_serving_mesh(width, "cpu")
    for real, batch in ((3, 8), (8, 8), (1, 16), (5, 6), (13, 13)):
        meshctx.record_shard_utilization(got, sm, real, batch)
        ref_meshctx.record_shard_utilization(want, _ref_mesh(width), real,
                                             batch)
    assert got.snapshot() == want.snapshot()
    assert hash(sm) == hash(meshctx.make_serving_mesh(width, "cpu"))


def test_make_serving_mesh_raises(monkeypatch):
    with pytest.raises(ValueError, match="at least one shard"):
        meshctx.make_serving_mesh(0, "cpu")
    with pytest.raises(ValueError, match="at least 1"):
        EngineConfig(serving_devices=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    two = meshctx.make_serving_mesh(2, "cuda")
    assert two.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="serving mesh wants 3 devices"):
        meshctx.make_serving_mesh(3, "cuda")
    # an installed mesh on the card is not handed to a caller on the host
    with meshctx.serving_mesh(two):
        with pytest.raises(ValueError, match="installed serving mesh"):
            meshctx.get_serving_mesh("cpu")
