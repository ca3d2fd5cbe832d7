"""The port's int8 gradient all-reduce with error feedback
(``repro_torch.distributed.gradient_compression.compressed_psum``) over
four gloo ranks, against the reference's under ``shard_map`` over four
host devices (a subprocess with ``XLA_FLAGS``, as the reference's
``tests/test_distributed.py`` runs it).

Both quantize the same float32 inputs with one shared scale, so the means
and the residuals must agree within one quantization step (the scale)
elementwise; they differ only where a value lies on a rounding boundary.
As in the reference's test, the mean is within 5e-2 of the exact mean
relative to its largest magnitude, and a second round with the same
gradients does not raise the bias."""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.mesh import make_mesh, run_ranks  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
N = 4


def _grads():
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((N, 64, 32)).astype(np.float32),
            "b": (rng.standard_normal((N, 48)) * 1e-3).astype(np.float32)}


REFERENCE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed.compat import shard_map
from repro.distributed.gradient_compression import compressed_psum
with open(sys.argv[1], "rb") as f:
    g_all = pickle.load(f)
mesh = jax.make_mesh((%d,), ("data",))
spec = {k: P("data", *([None] * (v.ndim - 1))) for k, v in g_all.items()}
def local(gs, errs):
    mean, new = compressed_psum({k: v[0] for k, v in gs.items()},
                                {k: v[0] for k, v in errs.items()}, "data")
    return ({k: v[None] for k, v in mean.items()},
            {k: v[None] for k, v in new.items()})
f = jax.jit(shard_map(local, mesh=mesh, in_specs=(spec, spec),
                      out_specs=(spec, spec)))
g = {k: jnp.asarray(v) for k, v in g_all.items()}
err = {k: jnp.zeros(v.shape, jnp.float32) for k, v in g_all.items()}
out = []
for _ in range(2):
    mean, err = f(g, err)
    out.append(({k: np.asarray(v) for k, v in mean.items()},
                {k: np.asarray(v) for k, v in err.items()}))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
""" % N


def _ranks(rank, out, g_all):
    from repro_torch.distributed.collectives import (collective_counts,
                                                     reset_collective_counts)
    from repro_torch.distributed.gradient_compression import (
        compressed_psum, init_error_state)

    mesh = make_mesh((N,), ("data",), "cpu")
    group = mesh.get_group("data")
    g = {k: torch.from_numpy(v[rank]) for k, v in g_all.items()}
    err = init_error_state(g)
    rounds = []
    reset_collective_counts()
    for _ in range(2):
        mean, err = compressed_psum(g, err, group)
        rounds.append(({k: v.numpy() for k, v in mean.items()},
                       {k: v.numpy() for k, v in err.items()}))
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(dict(rounds=rounds, counts=collective_counts()), f)


def test_compressed_psum_matches_the_reference_over_four_ranks(tmp_path):
    g_all = _grads()
    with open(tmp_path / "g.pkl", "wb") as f:
        pickle.dump(g_all, f)
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N}",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE),
         str(tmp_path / "g.pkl"), str(tmp_path / "ref.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        run_ranks(_ranks, N, str(tmp_path / "store"),
                  args=(str(tmp_path), g_all), device="cpu", timeout=180)
        _, err_txt = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err_txt
    with open(tmp_path / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    got = []
    for r in range(N):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    # two rounds, each one MAX of the two leaves' scales and one SUM of
    # their int8 values packed as int32
    assert got[0]["counts"] == {
        "all_reduce_max": {"calls": 2, "bytes": 2 * 2 * 4},
        "all_reduce_sum": {"calls": 2, "bytes": 2 * 4 * (64 * 32 + 48)}}
    rels = []
    for rnd in range(2):
        for k, g in g_all.items():
            true = g.mean(axis=0)
            g32 = g + (want[rnd - 1][1][k] if rnd else 0)
            step = float(np.abs(g32).max(axis=tuple(range(1, g.ndim))).max()
                         ) / 127.0
            for r in range(N):
                mean, res = got[r]["rounds"][rnd][0][k], got[r]["rounds"][rnd][1][k]
                assert mean.dtype == res.dtype == np.float32
                assert float(np.abs(mean - want[rnd][0][k][r]).max()) <= step
                assert float(np.abs(res - want[rnd][1][k][r]).max()) <= step
                assert np.array_equal(mean, got[0]["rounds"][rnd][0][k])
            if k == "w":
                rels.append(float(np.abs(got[0]["rounds"][rnd][0][k] - true
                                         ).max() / np.abs(true).max()))
    assert rels[0] < 0.05
    # error feedback: the mean of two rounds with the same gradients is no
    # further from the exact mean than one round
    two = (got[0]["rounds"][0][0]["w"] + got[0]["rounds"][1][0]["w"]) / 2
    true = g_all["w"].mean(axis=0)
    assert float(np.abs(two - true).max() / np.abs(true).max()) <= \
        rels[0] + 1e-6
