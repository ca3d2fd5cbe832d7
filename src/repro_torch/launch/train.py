"""Port of ``repro/launch/train.py``: the training launcher CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --shape train_4k --steps 200 [--smoke] [--devices N] [--data-par N]
        [--model-par N] [--fsdp] [--grad-compression] [--seq-len N]
        [--batch N] [--ckpt-dir DIR] [--ckpt-every N] [--device cuda|cpu]
        [--timeout SECONDS]

The reference's flags, plus ``--device`` (default ``cuda``; ``cpu`` runs
the plain versions of the kernels). ``--arch`` takes every config, those
with MoE, Mamba and xLSTM layers included. ``--smoke`` swaps in the reduced
config and a small shape (sequence 128, batch 8, unless given) so the
launcher runs end to end on a CPU.

With ``--devices 1`` and no mesh flag the single-device path runs in this
process. Otherwise the launcher starts ``--devices`` ranks itself (the
reference forces that many host devices instead): gloo processes for
``--device cpu``, and NCCL processes with one card a rank for ``cuda``,
joined with a timeout. They train over a (data, model) mesh of
``--data-par`` × ``--model-par`` (the data width defaults to devices //
model_par), with ``--fsdp`` and ``--grad-compression`` as the plan's
``fsdp_params`` and ``grad_compression``; ``--timeout`` bounds the ranks'
run. A split whose product is not ``--devices``, or more ranks than the
machine has cards, exits with an error, where the reference asserts.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="llama3.2-1b")
    p.add_argument("--shape", default="train_4k")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--devices", type=int, default=1)
    p.add_argument("--data-par", type=int, default=0,
                   help="data axis size (default devices//model_par)")
    p.add_argument("--model-par", type=int, default=1)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--grad-compression", action="store_true")
    p.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--seq-len", type=int, default=0)
    p.add_argument("--batch", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--timeout", type=float, default=3600.0,
                   help="seconds the ranks of a mesh run may take")
    return p


def _trainer(args, mesh=None, device=None):
    from ..configs import get_config, get_smoke_config
    from ..distributed.sharding import ExecutionPlan
    from ..models.config import SHAPES, ShapeSpec
    from ..train import Trainer, TrainerConfig

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if args.smoke:
        shape = ShapeSpec("smoke_train", args.seq_len or 128,
                          args.batch or 8, "train")
    else:
        base = SHAPES[args.shape]
        shape = ShapeSpec(base.name, args.seq_len or base.seq_len,
                          args.batch or base.global_batch, base.kind)
    plan = ExecutionPlan(fsdp_params=args.fsdp,
                         grad_compression=args.grad_compression)
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         total_steps=args.steps,
                         warmup_steps=max(args.steps // 20, 5))
    return Trainer(cfg, shape, tcfg, mesh=mesh, plan=plan,
                   device=device or args.device)


def _rank(rank: int, args, dp: int, mp: int) -> None:
    """One rank of a mesh run (``run_ranks`` has joined it to the group)."""
    from .mesh import make_mesh

    dev = "cpu" if args.device == "cpu" else f"cuda:{rank}"
    mesh = make_mesh((dp, mp), ("data", "model"), dev)
    _trainer(args, mesh, dev).run_with_restart(args.steps)


def main(argv: Optional[Sequence[str]] = None):
    p = _parser()
    args = p.parse_args(argv)
    mesh_flags = (args.devices != 1 or args.data_par > 1
                  or args.model_par > 1 or args.fsdp
                  or args.grad_compression)
    if not mesh_flags:
        out = _trainer(args).run_with_restart(args.steps)
        print("[train] done")
        return out

    import torch

    mp = args.model_par
    dp = args.data_par or args.devices // max(mp, 1)
    if args.devices < 1 or mp < 1 or dp * mp != args.devices:
        p.error(f"data_par × model_par must = devices: {dp} × {mp} != "
                f"{args.devices}")
    if args.device != "cpu" and args.devices > torch.cuda.device_count():
        p.error(f"--devices {args.devices}: the machine has "
                f"{torch.cuda.device_count()} CUDA devices (one a rank)")
    from .mesh import run_ranks

    store = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        run_ranks(_rank, args.devices, store, args=(args, dp, mp),
                  device=args.device, timeout=args.timeout)
    finally:
        import shutil

        shutil.rmtree(store, ignore_errors=True)
    print("[train] done")
    return None


if __name__ == "__main__":
    main()
