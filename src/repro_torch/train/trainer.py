"""Port of ``repro/train/trainer.py``: :class:`TrainerConfig` (:45) and
:class:`Trainer` (:58), the fault-tolerant training loop, on one device.

* **Checkpoint/restart**: atomic checkpoints of the parameters and the
  optimizer state every ``ckpt_every`` steps and at the end; on start the
  trainer resumes from the newest one. ``fail_at_step`` injects one failure
  (a ``RuntimeError`` raised before that step runs), and
  :meth:`Trainer.run_with_restart` restores and continues.
* **Straggler detection**: an EMA of the step's wall time; a step slower
  than ``straggler_factor`` times it is recorded in ``straggler_events``.
* **The step** (:meth:`Trainer.step`): ``loss_fn``, ``backward``,
  ``warmup_cosine``, ``adamw_update``; the gradients are set to ``None``
  between steps. On the card the attention of a long sequence runs the
  flash-attention kernel forward and its hand-written backward kernel.

The reference jits its step and, given a mesh, shards parameters, optimizer
state (ZeRO) and batch over it, with optional gradient compression. The
mesh half waits for its own slice (ROADMAP §1, item 3.1b): a ``mesh`` other
than ``None`` raises ``NotImplementedError``, and the reference's
``data_axes`` and ``model_axis`` arguments wait with it. The checkpoint
directory defaults to one under the temporary directory. Parameters come
from :func:`repro_torch.models.init_params` with a ``torch.Generator`` seeded
with ``TrainerConfig.seed`` on the device, where the reference draws from
``PRNGKey(seed)``; state carried over from the reference
(:func:`repro_torch.convert.lm_params_from_jax`,
:func:`repro_torch.convert.lm_opt_state_from_jax`) trains to the same
losses.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from ..device import resolve_device
from ..distributed.sharding import ExecutionPlan
from ..models.config import ModelConfig, ShapeSpec
from ..models.transformer import init_params, loss_fn
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .data import SyntheticData
from .optimizer import AdamWConfig, adamw_update, init_opt_state, tree_map
from .schedule import warmup_cosine

__all__ = ["Trainer", "TrainerConfig"]


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    keep_last: int = 3
    total_steps: int = 200
    warmup_steps: int = 20
    straggler_factor: float = 3.0
    log_every: int = 10
    fail_at_step: Optional[int] = None   # failure injection (tests)
    seed: int = 0


class Trainer:
    """Trains ``cfg`` on ``shape``'s synthetic batches on ``device``
    (default: the card)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec,
                 tcfg: TrainerConfig = TrainerConfig(),
                 ocfg: AdamWConfig = AdamWConfig(),
                 mesh=None, plan: ExecutionPlan = ExecutionPlan(),
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "training over a mesh (sharded parameters, ZeRO optimizer "
                "state, gradient compression) waits for its own slice "
                "(ROADMAP §1, item 3.1b)")
        self.cfg = plan.apply(cfg)
        self.shape = shape
        self.tcfg, self.ocfg, self.plan = tcfg, ocfg, plan
        self.device = resolve_device(device)
        self.data = SyntheticData(self.cfg, shape, seed=tcfg.seed,
                                  device=self.device)
        self.straggler_events: List[Dict[str, float]] = []

    # -- state init / restore -------------------------------------------------
    def init_state(self):
        """Seeded parameters (requiring gradients) and a fresh optimizer
        state."""
        params = init_params(self.cfg, torch.Generator(
            device=self.device).manual_seed(self.tcfg.seed))
        tree_map(lambda p: p.requires_grad_(True), params)
        return params, init_opt_state(params)

    def try_restore(self, params, opt):
        step = latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return 0, params, opt
        _, trees, _ = restore_checkpoint(
            self.tcfg.ckpt_dir, {"params": params, "opt": opt})
        params, opt = trees["params"], trees["opt"]
        tree_map(lambda p: p.requires_grad_(True), params)
        print(f"[trainer] restored checkpoint at step {step}")
        return step, params, opt

    # -- the step ---------------------------------------------------------
    def step(self, params, opt, batch, step: int):
        """One optimizer step on ``batch``: the loss and its gradient, the
        learning-rate scale at ``step``, AdamW. Updates ``params`` and
        ``opt`` in place; returns (params, opt, metrics) with the metrics
        as 0-d tensors (loss, ce, aux, grad_norm), not synced."""
        cfg, tcfg = self.cfg, self.tcfg
        tree_map(lambda p: setattr(p, "grad", None), params)
        loss, metrics = loss_fn(cfg, params, batch)
        loss.backward()
        grads = tree_map(lambda p: p.grad, params)
        lr_scale = warmup_cosine(step, warmup_steps=tcfg.warmup_steps,
                                 total_steps=tcfg.total_steps)
        params, opt, om = adamw_update(grads, opt, params, self.ocfg,
                                       lr_scale)
        tree_map(lambda p: setattr(p, "grad", None), params)
        metrics = {k: v.detach() for k, v in dict(loss=loss, **metrics,
                                                  **om).items()}
        return params, opt, metrics

    # -- loop -------------------------------------------------------------
    def run(self, steps: Optional[int] = None,
            on_metrics: Optional[Callable[[int, dict], None]] = None):
        steps = steps or self.tcfg.total_steps
        params, opt = self.init_state()
        start, params, opt = self.try_restore(params, opt)
        ema = None
        step = start
        while step < steps:
            batch = self.data.batch(step)
            t0 = time.perf_counter()
            if (self.tcfg.fail_at_step is not None
                    and step == self.tcfg.fail_at_step):
                self.tcfg.fail_at_step = None  # fail once
                raise RuntimeError(f"injected failure at step {step}")
            params, opt, metrics = self.step(params, opt, batch, step)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            if ema is None:
                ema = dt
            elif dt > self.tcfg.straggler_factor * ema:
                self.straggler_events.append(dict(step=step, dt=dt, ema=ema))
                print(f"[trainer] straggler step {step}: "
                      f"{dt:.2f}s vs EMA {ema:.2f}s")
            ema = 0.9 * ema + 0.1 * dt if ema else dt
            if on_metrics:
                on_metrics(step, metrics)
            if step % self.tcfg.log_every == 0:
                print(f"[trainer] step {step} loss={metrics['loss']:.4f} "
                      f"({dt*1e3:.0f} ms)")
            step += 1
            if step % self.tcfg.ckpt_every == 0 or step == steps:
                save_checkpoint(self.tcfg.ckpt_dir, step,
                                {"params": params, "opt": opt},
                                keep_last=self.tcfg.keep_last)
        return params, opt

    def run_with_restart(self, steps: Optional[int] = None, max_retries=2):
        """Run; on failure restore from the newest checkpoint and continue —
        the node-failure recovery path."""
        for attempt in range(max_retries + 1):
            try:
                return self.run(steps)
            except RuntimeError as e:
                print(f"[trainer] failure ({e}); restarting "
                      f"(attempt {attempt + 1}/{max_retries})")
        raise RuntimeError("exceeded max retries")
