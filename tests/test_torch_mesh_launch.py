"""The training launcher over a mesh on the CPU: ``--devices 4`` starts
four gloo ranks itself, which train llama3.2-1b's smoke config over a
2 × 2 (data, model) mesh with FSDP parameters and int8-compressed
gradients, and leave a logical checkpoint of the last step; a split that
does not multiply to ``--devices`` exits with code 2."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.train import (init_opt_state, latest_step,  # noqa: E402
                               restore_checkpoint)
from repro_torch.train.optimizer import tree_leaves  # noqa: E402


def test_the_launcher_trains_over_four_gloo_ranks(tmp_path, capfd):
    out = train_launcher.main([
        "--smoke", "--device", "cpu", "--devices", "4", "--model-par", "2",
        "--fsdp", "--grad-compression", "--steps", "3", "--seq-len", "16",
        "--batch", "4", "--ckpt-dir", str(tmp_path / "ck"),
        "--timeout", "240"])
    assert out is None
    assert latest_step(str(tmp_path / "ck")) == 3
    shapes = init_params(get_smoke_config("llama3.2-1b"), None)
    _, trees, _ = restore_checkpoint(
        str(tmp_path / "ck"), {"params": shapes,
                               "opt": init_opt_state(shapes)}, device="cpu")
    assert int(trees["opt"]["count"]) == 3
    for got, want in zip(tree_leaves(trees["params"]), tree_leaves(shapes)):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert bool(torch.isfinite(got.float()).all())
    assert "[train] done" in capfd.readouterr().out


@pytest.mark.parametrize("flags", [
    ["--devices", "4", "--model-par", "3"],
    ["--devices", "4", "--data-par", "2", "--model-par", "1"],
    ["--devices", "0"]])
def test_a_split_that_is_not_the_device_count_exits_2(flags, capsys):
    with pytest.raises(SystemExit) as e:
        train_launcher.main(["--smoke", "--device", "cpu"] + flags)
    assert e.value.code == 2
    assert "data_par × model_par must = devices" in capsys.readouterr().err
