"""``scripts/engine_status_torch.py``, the port's engine-status script: it
renders a port bundle's report card, a port bundle registry and a live
port RPC server's stats (the serving mesh's per-shard panel included, here
over two CPU shards), exits nonzero on a missing bundle, and imports
neither ``jax`` nor ``repro``."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.features import (FEATURE_NAMES,  # noqa: E402
                                       extract_features_batch)
from repro_torch.core.ml import RandomForestClassifier  # noqa: E402
from repro_torch.core.scaling import SCALERS  # noqa: E402
from repro_torch.core.selector import ReorderSelector  # noqa: E402
from repro_torch.distributed import meshctx  # noqa: E402
from repro_torch.engine import EngineConfig, SolverEngine  # noqa: E402
from repro_torch.launch.rpc import PlanRPCClient  # noqa: E402
from repro_torch.lifecycle.registry import BundleRegistry  # noqa: E402
from repro_torch.sparse.dataset import generate_suite  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCRIPT = os.path.join(ROOT, "scripts", "engine_status_torch.py")
T = 60.0

#: runs the script as __main__, then reports whether JAX or the reference
#: package was imported
_RUN = textwrap.dedent("""
    import runpy, sys
    sys.argv = sys.argv[1:]
    rc = 0
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    except SystemExit as e:
        rc = e.code or 0
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    print("IMPORTED", bad)
    sys.exit(rc)
""")


def _status(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-c", _RUN, SCRIPT, *args],
                          capture_output=True, text=True, timeout=120,
                          env=env)


@pytest.fixture(scope="module")
def engine():
    mats = list(generate_suite(count=8, seed=3, size_scale=0.2))
    feats = extract_features_batch(mats)
    labels = (feats[:, FEATURE_NAMES.index("bandwidth")]
              / np.maximum(feats[:, 0], 1) > 0.5).astype(int)
    labels[:2] = 1 - labels[:2]
    scaler = SCALERS["standard"]().fit(feats)
    rf = RandomForestClassifier(n_estimators=4).fit(
        scaler.transform(feats), labels)
    sel = ReorderSelector(rf, scaler, ["amd", "rcm"])
    return SolverEngine(EngineConfig(batch_size=4, max_wait_ms=2.0,
                                     device="cpu", serving_devices=2),
                        selector=sel), mats


def test_renders_bundle_registry_and_live_server(engine, tmp_path):
    eng, mats = engine
    path = eng.save(str(tmp_path / "sel.bundle"))
    reg = BundleRegistry(str(tmp_path / "reg"))
    reg.mark_serving(reg.register(path)["version"])
    srv = eng.serve(rpc=True, port=0)
    try:
        with PlanRPCClient(srv.host, srv.port, timeout=T) as c:
            for a in mats + mats[:3]:
                assert c.plan(a).algorithm in ("amd", "rcm")
        r = _status("--bundle", path, "--registry", str(tmp_path / "reg"),
                    "--host", srv.host, "--port", str(srv.port))
    finally:
        srv.close(timeout=T)
        meshctx.set_serving_mesh(None)
    assert r.returncode == 0, r.stdout + r.stderr
    out = r.stdout
    assert f"fingerprint {eng.fingerprint}" in out
    assert "model       random_forest" in out
    assert "registry    " in out and "(1 bundles)" in out and "▶" in out
    assert f"server      {srv.host}:{srv.port}" in out
    assert "traffic     11 requests" in out
    assert "mesh        2 shard(s)" in out
    assert "shard 0" in out and "shard 1" in out
    assert "IMPORTED []" in out


def test_exits_nonzero_on_a_missing_bundle(tmp_path):
    r = _status("--bundle", str(tmp_path / "nope.bundle"))
    assert r.returncode != 0
    assert "cannot load bundle" in r.stdout
    assert "IMPORTED []" in r.stdout
