"""Port of ``repro/launch/train.py``: the training launcher CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --shape train_4k --steps 200 [--smoke] [--seq-len N] [--batch N] \\
        [--ckpt-dir DIR] [--ckpt-every N] [--device cuda|cpu]

The reference's flags, plus ``--device`` (default ``cuda``; ``cpu`` runs
the plain versions of the kernels). ``--smoke`` swaps in the reduced config
and a small shape (sequence 128, batch 8, unless given) so the launcher
runs end to end on a CPU. This is the single-device path, the reference's
``--devices 1``: ``--devices`` > 1, ``--data-par`` or ``--model-par`` > 1,
``--fsdp`` and ``--grad-compression`` need a mesh, which waits for its own
slice (ROADMAP §1, item 3.1b), and exit with an error naming it.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
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
    args = p.parse_args(argv)

    mesh_flags = [f for f, on in (
        ("--devices > 1", args.devices > 1),
        ("--data-par > 1", args.data_par > 1),
        ("--model-par > 1", args.model_par > 1),
        ("--fsdp", args.fsdp),
        ("--grad-compression", args.grad_compression)) if on]
    if mesh_flags:
        p.error(f"{', '.join(mesh_flags)}: training over a mesh is not "
                f"ported yet (ROADMAP §1, item 3.1b); the port trains on "
                f"one device")

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

    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         total_steps=args.steps,
                         warmup_steps=max(args.steps // 20, 5))
    trainer = Trainer(cfg, shape, tcfg, plan=ExecutionPlan(),
                      device=args.device)
    out = trainer.run_with_restart(args.steps)
    print("[train] done")
    return out


if __name__ == "__main__":
    main()
