"""Train one model over a (data, model) mesh of several ranks and on one
device, from the same seed, batches and learning rate, and print each
run's losses, grad norms, step wall times, tokens/s, peak device memory
and the collectives of a step, one JSON line a run, then the largest
relative difference of the losses.

    python3 scripts/mesh_train_compare.py --devices 4 --data-par 2 \\
        --model-par 2 [--fsdp] [--grad-compression] [--steps 3]
    PYTHONPATH=src python scripts/mesh_train_compare.py --smoke \\
        --device cpu --devices 4 --model-par 2         # a rehearsal on the CPU

On CUDA each rank takes one card (NCCL); the single-device run takes card
0 after the ranks have finished. The defaults are llama3.2-1b at full
width and depth, 8 sequences of 4,096 tokens (a 2 × 2 mesh gives each data
rank 4 of them, the card's ``chip_smoke.py`` batch) and the learning rate
``chip_smoke.py`` trains at.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _run(trainer, steps: int, tokens: int) -> dict:
    import torch

    from repro_torch.distributed.collectives import (collective_counts,
                                                     reset_collective_counts)

    cuda = trainer.device.type == "cuda"
    params, opt = trainer.init_state()
    out = dict(losses=[], grad_norms=[], wall_ms=[])
    for step in range(steps):
        batch = trainer.batch(step)
        if cuda:
            torch.cuda.synchronize()
        reset_collective_counts()
        t0 = time.perf_counter()
        params, opt, m = trainer.step(params, opt, batch, step)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        if cuda:
            torch.cuda.synchronize()
        out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
    warm = out["wall_ms"][1:] or out["wall_ms"]
    out["tokens_per_s"] = tokens * len(warm) / (sum(warm) / 1e3)
    out["collectives_a_step"] = collective_counts()
    if cuda:
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def _trainer(args, mesh=None, device=None):
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed.sharding import ExecutionPlan
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    plan = (ExecutionPlan(fsdp_params=args.fsdp,
                          grad_compression=args.grad_compression)
            if mesh is not None else ExecutionPlan())
    return Trainer(cfg, ShapeSpec("t", args.seq_len, args.batch, "train"),
                   TrainerConfig(ckpt_dir=args.ckpt_dir, total_steps=100,
                                 warmup_steps=1, log_every=10 ** 9),
                   AdamWConfig(lr=args.lr), mesh=mesh, plan=plan,
                   device=device or args.device)


def _rank(rank: int, args, out_dir: str) -> None:
    from repro_torch.launch.mesh import make_mesh

    dev = "cpu" if args.device == "cpu" else f"cuda:{rank}"
    dp = args.data_par or args.devices // args.model_par
    mesh = make_mesh((dp, args.model_par), ("data", "model"), dev)
    res = _run(_trainer(args, mesh, dev), args.steps,
               args.batch * args.seq_len)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="llama3.2-1b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--seq-len", type=int, default=4096)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--devices", type=int, default=4)
    p.add_argument("--data-par", type=int, default=0)
    p.add_argument("--model-par", type=int, default=2)
    p.add_argument("--fsdp", action="store_true")
    p.add_argument("--grad-compression", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--timeout", type=float, default=900.0)
    args = p.parse_args(argv)
    args.ckpt_dir = tempfile.mkdtemp(prefix="mesh_train_compare_")

    from repro_torch.launch.mesh import run_ranks

    tokens = args.batch * args.seq_len
    out_dir = tempfile.mkdtemp(prefix="mesh_train_compare_out_")
    t0 = time.perf_counter()
    run_ranks(_rank, args.devices, out_dir, args=(args, out_dir),
              device=args.device, timeout=args.timeout)
    ranks = []
    for r in range(args.devices):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    mesh = dict(ranks[0], run="mesh", devices=args.devices,
                data_par=args.data_par or args.devices // args.model_par,
                model_par=args.model_par, fsdp=args.fsdp,
                grad_compression=args.grad_compression,
                seconds=time.perf_counter() - t0)
    if "peak_gb" in ranks[0]:
        mesh["peak_gb_by_rank"] = [r["peak_gb"] for r in ranks]
    print(json.dumps(mesh), flush=True)
    if any(r["losses"] != ranks[0]["losses"] for r in ranks):
        print(json.dumps({"error": "the ranks report different losses",
                          "losses": [r["losses"] for r in ranks]}))
        return 1
    single = dict(_run(_trainer(args), args.steps, tokens), run="single")
    print(json.dumps(single), flush=True)
    rel = max(abs(a - b) / abs(b) for a, b in zip(mesh["losses"],
                                                  single["losses"]))
    print(json.dumps({"max_relative_loss_difference": rel}))
    if args.device != "cpu":
        import subprocess

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
