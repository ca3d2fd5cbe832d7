"""The PyTorch port stands alone: it loads neither JAX nor the JAX package,
and it never falls back from the card to the CPU on its own."""
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    mods = _port_modules()
    for m in ("repro_torch.sparse.numeric", "repro_torch.core.labeling",
              "repro_torch.kernels.frontal_cholesky"):
        assert m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


_IMPORT = re.compile(r"^\s*(from|import)\s+(repro|jax)(\.|\s|$)", re.M)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_static_import_of_repro_or_jax(path):
    assert not _IMPORT.findall(path.read_text())


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch import resolve_device
    from repro_torch.core.plan import PlanBuilder, execute_plan
    from repro_torch.sparse.dataset import grid2d
    from repro_torch.sparse.multifrontal import multifrontal_cholesky

    a = grid2d(4, 4, "g4")
    plan = PlanBuilder().build(a, "nd")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        execute_plan(a, plan, np.ones(a.n))
    with pytest.raises(RuntimeError, match="CUDA"):
        multifrontal_cholesky(a)
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_wrappers_refuse_devices_other_than_cpu():
    """A tensor off the CPU never reaches a plain version: the wrappers
    launch the kernel or raise (here: the meta device, and a CPU/meta mix)."""
    from repro_torch.kernels import frontal_cholesky as fc
    from repro_torch.kernels.spmv_bell import bell_spmv

    meta = torch.empty((1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fc.frontal_factor_batch(meta, 8, bs=8)
    with pytest.raises(ValueError, match="CUDA"):
        fc.tri_solve_batch(meta, torch.empty((1, 8, 1)), bs=8)
    with pytest.raises(ValueError, match="CUDA"):
        fc.extend_add_batch(meta, torch.empty((1, 8, 8)), [0],
                            np.zeros((1, 8), np.int32))
    tile = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fc.chol_tile(tile)
    with pytest.raises(ValueError, match="CUDA"):
        fc.tri_inv_tile(tile)
    with pytest.raises(ValueError, match="CUDA"):
        fc.matmul_nt(tile, torch.empty((8, 8)), torch.empty((8, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        bell_spmv(torch.empty((1, 1, 8, 8), dtype=torch.float64,
                              device="meta"),
                  torch.zeros((1, 1), dtype=torch.int32),
                  torch.zeros(8, dtype=torch.float64))


def test_scans_cover_the_lm_modules():
    """The subprocess import and the static scan above reach the LM
    serving modules: models (the mixers too), configs, the launcher and
    the attention kernel's wrapper."""
    mods = _port_modules()
    for m in ("repro_torch.models.transformer", "repro_torch.models.layers",
              "repro_torch.models.moe", "repro_torch.models.ssm",
              "repro_torch.models.xlstm",
              "repro_torch.configs", "repro_torch.configs.qwen3_1_7b",
              "repro_torch.launch.serve", "repro_torch.kernels.flash_attention"):
        assert m in mods, m
    scanned = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"models/transformer.py", "configs/jamba_v0_1_52b.py",
            "launch/serve.py", "convert.py"} <= scanned


def test_flash_attention_refuses_devices_other_than_cpu():
    """The attention wrapper, its entry point and the model's chunked
    branch launch the kernel for a tensor off the CPU or raise: they never
    run the plain version there (here: the meta device, a mix, and the
    default device without a card)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.layers import gqa_attention

    meta = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(meta, torch.empty((1, 2, 8, 16)), meta)
    with pytest.raises(ValueError, match="CUDA"):
        gqa_attention(meta, meta, meta, causal=True, q_chunk=4, kv_chunk=4,
                      impl="chunked")
    if not torch.cuda.is_available():
        from repro_torch.configs import get_smoke_config
        from repro_torch.launch import serve
        from repro_torch.models import init_cache

        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--smoke"])
        with pytest.raises(RuntimeError, match="CUDA"):
            init_cache(get_smoke_config("qwen3-1.7b"), 1, 8)
