"""LM decode from a sequence-sharded KV cache on the CPU.

* ``sharded_decode_attention`` against the reference's: the reference runs
  in one subprocess on 8 forced host devices over its (4, 2) mesh with
  ``seq_axes=("data", "model")`` (B 1, Hq 4, Hkv 2, S 64, hd 16, pos 37, as
  ``tests/test_distributed.py`` drives it); the port runs the same inputs in
  one spawn of four gloo ranks over a 2 × 2 mesh with
  ``("data", "model")`` and a 4 × 1 mesh with ``("data",)``. Outputs within
  1e-5, the cache update bit-exact.
* In the same spawn, llama3.2-1b's and qwen3-1.7b's smoke configs in
  float32 served over 2 × 2 and 4 × 1 meshes at B 1 (the cache's sequence
  sharded) and B 4 (the batch over the data axis), against the port's
  one-device ``prefill`` + 8 ``decode_step``\\ s: logits within 1e-5
  relative, tokens equal.
* ``cache_specs`` against the reference's ``PartitionSpec``\\ s for all ten
  archs at ``decode_32k`` and ``long_500k`` (no ranks; the reference's
  leading ``None`` over stacked groups drops), and the dry run's decode
  rule.
* ``repro_torch.launch.serve --devices 4 --smoke --device cpu`` (four
  ranks it starts itself) against the one-device launcher, and its exit 2
  on a bad split.

Rank functions are module level, and JAX is imported only inside the
fixtures and tests, so that the ranks never load it."""
import dataclasses
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed.meshctx import MeshContext  # noqa: E402
from repro_torch.distributed.sharding import (ExecutionPlan,  # noqa: E402
                                              cache_specs,
                                              decode_seq_axes_for)
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch.mesh import make_mesh, run_ranks  # noqa: E402
from repro_torch.models import decode_step, init_params, prefill  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.models.layers import sharded_decode_attention  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ("llama3.2-1b", "qwen3-1.7b")
MESHES = ((2, 2, ("data", "model")), (4, 1, ("data",)))
PROMPT, STEPS = 12, 8
POS = 37


def _f32(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def _prompt(cfg, b):
    rng = np.random.default_rng(5)
    return {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (b, PROMPT)))}


def _params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(1))


def _one_device(cfg, b):
    """The port's one-device prefill + STEPS greedy decode steps."""
    params, batch = _params(cfg), _prompt(cfg, b)
    logits, cache = prefill(cfg, params, batch, max_seq=PROMPT + STEPS)
    first, toks = logits, []
    tok = logits.argmax(-1)[:, None]
    for _ in range(STEPS):
        logits, cache = decode_step(cfg, params, cache, tok)
        tok = logits.argmax(-1)[:, None]
        toks.append(tok[:, 0].numpy())
    return first, logits, np.stack(toks, axis=1)


def _rank(rank: int, inputs: str, out_dir: str) -> None:
    """Every mesh case on this rank; rank 0 writes what it gathered."""
    data = np.load(inputs)
    got = {}
    for dp, mp, seq_axes in MESHES:
        mesh = make_mesh((dp, mp), ("data", "model"), "cpu")
        tag = f"{dp}x{mp}"
        # the attention alone: this rank's slice of the 64 positions
        ctx = MeshContext(mesh)
        n = ctx.size(seq_axes)
        i = ctx.index(seq_axes)
        s_loc = data["ck"].shape[2] // n
        cut = slice(i * s_loc, (i + 1) * s_loc)
        ck = torch.from_numpy(data["ck"][:, :, cut].copy())
        cv = torch.from_numpy(data["cv"][:, :, cut].copy())
        out, ck2, cv2 = sharded_decode_attention(
            torch.from_numpy(data["q"]), ck, cv,
            torch.from_numpy(data["kn"]), torch.from_numpy(data["vn"]), POS,
            ctx=ctx, seq_axes=seq_axes, rep=2)
        # every rank's slice, put back in the order of the sequence
        mine = torch.stack([ck2, cv2])
        parts = [torch.empty_like(mine) for _ in range(4)]
        ids = [torch.empty(1, dtype=torch.int64) for _ in range(4)]
        torch.distributed.all_gather(parts, mine)
        torch.distributed.all_gather(ids, torch.tensor([i]))
        by_index = {int(j): p for j, p in zip(ids, parts)}
        cat = torch.cat([by_index[j] for j in range(n)], dim=3)
        got[f"{tag}_out"] = out.numpy()
        got[f"{tag}_ck"], got[f"{tag}_cv"] = cat[0].numpy(), cat[1].numpy()
        # the served models
        for arch in ARCHS:
            cfg = _f32(arch)
            for b in (1, 4):
                res = serve_launcher.serve_on_mesh(
                    cfg, _params(cfg), _prompt(cfg, b), STEPS, mesh)
                key = f"{tag}_{arch}_b{b}"
                got[key + "_first"] = res["prefill_logits"].numpy()
                got[key + "_last"] = res["logits"].numpy()
                got[key + "_tokens"] = res["tokens"]
                got[key + "_seq"] = np.array(
                    res["ctx"].decode_seq_axes or (), dtype="U8")
    if rank == 0:
        np.savez(os.path.join(out_dir, "ranks.npz"), **got)


_REFERENCE = """
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.models.layers import sharded_decode_attention
    mesh = jax.make_mesh((4, 2), ("data", "model"))
    d = np.load(sys.argv[1])
    out, ck2, cv2 = jax.jit(lambda *a: sharded_decode_attention(
        *a, mesh=mesh, seq_axes=("data", "model"), rep=2))(
        *(jnp.asarray(d[k]) for k in ("q", "ck", "cv", "kn", "vn")),
        jnp.int32(%d))
    np.savez(sys.argv[2], out=np.asarray(out), ck=np.asarray(ck2),
             cv=np.asarray(cv2))
""" % POS


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decode_mesh")
    rng = np.random.default_rng(0)
    b, hq, hkv, s, hd = 1, 4, 2, 64, 16
    inputs = {k: rng.standard_normal(shape).astype(np.float32)
              for k, shape in (("q", (b, hq, 1, hd)), ("ck", (b, hkv, s, hd)),
                               ("cv", (b, hkv, s, hd)),
                               ("kn", (b, hkv, 1, hd)),
                               ("vn", (b, hkv, 1, hd)))}
    path = str(tmp / "inputs.npz")
    np.savez(path, **inputs)
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE), path,
         str(tmp / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        run_ranks(_rank, 4, str(tmp), args=(path, str(tmp)), device="cpu",
                  timeout=240)
    finally:
        _, err = ref.communicate(timeout=240)
    assert ref.returncode == 0, err
    return inputs, dict(np.load(tmp / "ref.npz")), dict(
        np.load(tmp / "ranks.npz"))


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_sharded_decode_attention_matches_the_reference(runs, mesh):
    inputs, ref, got = runs
    np.testing.assert_allclose(got[f"{mesh}_out"], ref["out"], rtol=0,
                               atol=1e-5)
    # the cache update landed once, exactly, on the owner's slice
    want_k, want_v = inputs["ck"].copy(), inputs["cv"].copy()
    want_k[:, :, POS], want_v[:, :, POS] = (inputs["kn"][:, :, 0],
                                            inputs["vn"][:, :, 0])
    assert np.array_equal(ref["ck"], want_k)
    assert np.array_equal(got[f"{mesh}_ck"], want_k)
    assert np.array_equal(got[f"{mesh}_cv"], want_v)


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_served_tokens_over_a_mesh_equal_one_device(runs, mesh, arch, b):
    _, _, got = runs
    first, last, toks = _one_device(_f32(arch), b)
    key = f"{mesh}_{arch}_b{b}"
    for name, want in (("first", first), ("last", last)):
        g = got[f"{key}_{name}"]
        err = np.abs(g - want.numpy()).max() / np.abs(want.numpy()).max()
        assert err <= 1e-5, (name, err)
    assert np.array_equal(got[f"{key}_tokens"], toks)
    # a batch of 1 decodes from the sequence-sharded cache, 4 does not
    assert tuple(got[f"{key}_seq"]) == (("data",) if b == 1 else ())


def _unstacked(cfg, tree):
    """The reference's cache specs (groups stacked, a leading None) in the
    port's layout: one entry per layer."""
    def drop(p):
        assert p[0] is None
        return tuple(p)[1:]

    layers = []
    for g in range(cfg.num_groups):
        for j in range(cfg.pattern_period):
            layers.append({k: drop(v) for k, v in
                           tree["groups"][f"s{j}"].items()})
    return dict(pos=tuple(tree["pos"]), layers=layers)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_equal_the_reference(arch, shape):
    from repro.configs import get_config as ref_config
    from repro.distributed.sharding import cache_specs as ref_cache_specs
    from repro.models.config import SHAPES as REF_SHAPES

    rcfg, cfg = ref_config(arch), get_config(arch)
    for sizes, data_axes in (({"data": 16, "model": 16}, ("data",)),
                             ({"pod": 2, "data": 16, "model": 16},
                              ("pod", "data")),
                             ({"data": 2, "model": 3}, ("data",))):
        want = _unstacked(rcfg, ref_cache_specs(
            rcfg, REF_SHAPES[shape], types.SimpleNamespace(shape=sizes),
            data_axes=data_axes))
        got = cache_specs(cfg, SHAPES[shape], sizes, data_axes=data_axes)
        assert got == want, (sizes, data_axes)


def test_decode_rule_is_the_dry_runs():
    cfg = get_config("qwen3-1.7b")  # 8 kv heads
    on = ExecutionPlan(seq_shard_decode=True)
    sizes = {"data": 16, "model": 16}
    long, dec = SHAPES["long_500k"], SHAPES["decode_32k"]
    # off, the rule leaves a whole sequence alone and refuses a split one,
    # which the reference would gather and the port never does
    with pytest.raises(ValueError, match="seq_shard_decode is off"):
        decode_seq_axes_for(cfg, long, sizes, ExecutionPlan())
    assert decode_seq_axes_for(cfg, dec, {"data": 4, "model": 8},
                               ExecutionPlan()) is None
    # 8 kv heads do not tile 16 model ranks: the model axis joins the data
    assert decode_seq_axes_for(cfg, long, sizes, on) == ("data", "model")
    assert decode_seq_axes_for(cfg, long, {"data": 4, "model": 8},
                               on) == ("data",)
    # a batch that tiles the data axes: the cache's sequence is split only
    # where the kv heads do not tile the model axis
    assert decode_seq_axes_for(cfg, dec, {"data": 4, "model": 8},
                               on) is None
    assert decode_seq_axes_for(cfg, dec, sizes, on) == ("model",)


def test_serve_launcher_over_four_ranks(capfd):
    flags = ["--smoke", "--device", "cpu", "--batch", "1", "--prompt-len",
             "12", "--decode-steps", "4"]
    serve_launcher.main(flags)
    want = [l for l in capfd.readouterr().out.splitlines()
            if "sampled tokens" in l]
    assert serve_launcher.main(flags + ["--devices", "4", "--timeout",
                                        "240"]) is None
    got = [l for l in capfd.readouterr().out.splitlines()
           if "sampled tokens" in l]
    assert len(want) == 1 and got == want
    with pytest.raises(SystemExit) as e:
        serve_launcher.main(flags + ["--devices", "4", "--model-par", "3"])
    assert e.value.code == 2
    assert "data_par × model_par must = devices" in capfd.readouterr().err
