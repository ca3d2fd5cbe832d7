"""How much of the start of a device-only ``torch.profiler`` window the
profiler loses: at the start of a process; after heavy work of a few
repeated kernels under a device-only profile and under a host-and-device
one; after the process has loaded many distinct kernels; and after one
unprofiled training step of the port (llama3.2-1b at full width, 2
layers, 4 × 4,096 tokens).

    python3 scripts/profiler_window.py

A window opens on OPEN sleep kernels, each behind a sync, then runs 20
short kernels, a sync, and 5 sleep kernels. Each line says how many of the
opening sleeps, the short kernels and the closing sleeps the profiler
recorded, and how long one sleep kernel ran on the card, so the lost span
is about the missing opening sleeps times that. Needs a CUDA device;
imports torch, and the port for the training step.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

OPEN, CYCLES, WINDOWS = 40, 200_000, 3


def window(label: str) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1 << 20, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(OPEN):
            torch.cuda._sleep(CYCLES)
            torch.cuda.synchronize()
        for _ in range(20):
            x.add_(1.0)
        torch.cuda.synchronize()
        for _ in range(5):
            torch.cuda._sleep(CYCLES)
        torch.cuda.synchronize()
    evs = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA)
    work = [e for e in evs if "spin_kernel" not in e[2]]
    first = work[0][0] if work else float("inf")
    sleeps = [e for e in evs if "spin_kernel" in e[2]]
    opening = sum(1 for e in sleeps if e[0] < first)
    rec = dict(label=label, opening=f"{opening}/{OPEN}",
               short=f"{len(work)}/20",
               closing=f"{len(sleeps) - opening}/5",
               sleep_us=round(sum(e[1] - e[0] for e in sleeps)
                              / max(len(sleeps), 1), 1))
    print(json.dumps(rec), flush=True)
    return rec


def heavy(activities) -> None:
    """~6,000 kernels of matrix products and elementwise work, profiled."""
    import torch
    from torch.profiler import profile

    a = torch.randn(2048, 2048, device="cuda", dtype=torch.bfloat16)
    with profile(activities=activities):
        for _ in range(2000):
            a = torch.relu(a @ a.T * 1e-3) + 1e-3
        torch.cuda.synchronize()


def load_distinct() -> int:
    """Run 30 elementwise, scan and sort ops in 4 dtypes once each, each a
    kernel the process has not loaded yet; returns how many ran."""
    import torch

    scans = (torch.cumsum, torch.sort, torch.argsort, torch.cumprod,
             torch.logcumsumexp)
    ops = (torch.sin, torch.cos, torch.exp, torch.log1p, torch.tanh,
           torch.sigmoid, torch.erf, torch.sqrt, torch.abs, torch.neg,
           torch.floor, torch.round, torch.exp2, torch.expm1, torch.atan,
           torch.asin, torch.sinh, torch.cosh, torch.rsqrt, torch.reciprocal,
           torch.trunc, torch.sign, torch.erfinv, torch.lgamma,
           torch.digamma) + scans
    n = 0
    for dt in (torch.float32, torch.float16, torch.bfloat16, torch.float64):
        for op in ops:
            t = torch.rand(4097, device="cuda", dtype=dt) + 0.5
            try:
                op(t, 0) if op in scans else op(t)
                n += 1
            except RuntimeError:  # an op without a kernel for this dtype
                pass
    torch.cuda.synchronize()
    return n


def train_step() -> None:
    """One Trainer.step of llama3.2-1b at full width and 2 layers."""
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "src"))
    from repro_torch.configs import get_config
    from repro_torch.models.config import ShapeSpec
    from repro_torch.train import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=2)
    trainer = Trainer(cfg, ShapeSpec("train_4k", 4096, 4, "train"),
                      TrainerConfig(warmup_steps=1), device="cuda")
    params, opt = trainer.init_state()
    trainer.step(params, opt, trainer.data.batch(0), 0)
    torch.cuda.synchronize()
    del params, opt, trainer
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        print("profiler_window: no CUDA device", file=sys.stderr)
        return 2
    print(torch.cuda.get_device_name(0), torch.__version__,
          torch.version.cuda, flush=True)
    for i in range(WINDOWS):
        window(f"start {i}")
    heavy([ProfilerActivity.CUDA])
    for i in range(WINDOWS):
        window(f"after a device-only profile {i}")
    heavy([ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for i in range(WINDOWS):
        window(f"after a host-and-device profile {i}")
    n = load_distinct()
    for i in range(WINDOWS):
        window(f"after {n} distinct kernels loaded {i}")
    train_step()
    for i in range(WINDOWS):
        window(f"after an unprofiled training step {i}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
