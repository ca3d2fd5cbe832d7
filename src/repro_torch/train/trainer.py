"""Port of ``repro/train/trainer.py``: :class:`TrainerConfig` (:45) and
:class:`Trainer` (:58), the fault-tolerant training loop, on one device or
over a training mesh.

* **Checkpoint/restart**: atomic checkpoints of the parameters and the
  optimizer state every ``ckpt_every`` steps and at the end; on start the
  trainer resumes from the newest one. ``fail_at_step`` injects one failure
  (a ``RuntimeError`` raised before that step runs), and
  :meth:`Trainer.run_with_restart` restores and continues.
* **Elastic restart**: checkpoints hold logical arrays, under a mesh too
  (rank 0 writes the gathered arrays behind a barrier, and every rank cuts
  its shards from them on restore), so a checkpoint saved under one mesh
  restores under another or under none.
* **Straggler detection**: an EMA of the step's wall time, per rank; a step
  slower than ``straggler_factor`` times it is recorded in
  ``straggler_events``.
* **The step** (:meth:`Trainer.step`): ``loss_fn``, ``backward``, the
  gradient reduction, ``warmup_cosine``, ``adamw_update``; the gradients
  are set to ``None`` between steps. On the card the attention of a long
  sequence runs the flash-attention kernel forward and its hand-written
  backward kernel.

Over a mesh (``mesh``: a ``DeviceMesh`` from
:func:`repro_torch.launch.mesh.make_mesh`, with ``data_axes`` and
``model_axis`` as in the reference), where the reference jits its step
with shardings and lets GSPMD insert the collectives, each rank holds its
shards and the collectives are explicit:

* **Parameters** are laid out by ``param_specs`` (the model's mesh path
  reads the same layout from the mesh context: tensor-parallel attention,
  MLP, embedding and cross entropy over the model axis); with
  ``plan.fsdp_params`` they are also sharded over the data axes and
  all-gathered where a layer uses them (again when it is recomputed), their
  gradients reduce-scattered back. ``plan.pure_dp`` drops tensor
  parallelism: the whole mesh is one data/FSDP domain.
* **Batches**: each data rank takes its rows of ``SyntheticData``'s global
  batch (``batch_specs``); the global batch must divide over the data
  axes. Each rank's loss is the mean over its rows, the reported loss the
  mean over the data axes.
* **Gradient reduction**: the gradients are averaged over the data axes,
  through ``compressed_psum`` (int8 with an error-feedback residual per
  rank, kept in memory and not checkpointed) when ``plan.grad_compression``
  is set; gradients summed over the model axis are never compressed.
* **ZeRO**: the float32 master weights and the moments are sharded over the
  free data axes (``opt_state_spec_for``); each rank updates its slice, then
  all-gathers the parameters.
* **The global norm** of the clip and of ``grad_norm`` is the whole logical
  gradient's: each leaf's squares are summed over the axes it is sharded
  on, so a replicated leaf counts once.

A mesh over CUDA tensors runs NCCL, over CPU tensors gloo; any other
pairing raises. The checkpoint directory defaults to one under the
temporary directory. Parameters come from
:func:`repro_torch.models.init_params` with a ``torch.Generator`` seeded
with ``TrainerConfig.seed`` on the device, where the reference draws from
``PRNGKey(seed)``; state carried over from the reference
(:func:`repro_torch.convert.lm_params_from_jax`,
:func:`repro_torch.convert.lm_opt_state_from_jax`, then
:meth:`Trainer.from_logical`) trains to the same losses.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..distributed import collectives as C
from ..distributed.gradient_compression import compressed_psum
from ..distributed.meshctx import MeshContext, _axes, mesh_context
from ..distributed.sharding import (ExecutionPlan, batch_specs,
                                    kv_whole_specs, map_specs,
                                    opt_state_spec_for, param_specs,
                                    to_shardings)
from ..models.config import ModelConfig, ShapeSpec
from ..models.transformer import check_trainable, init_params, loss_fn
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .data import SyntheticData
from .optimizer import (AdamWConfig, adamw_update, init_opt_state,
                        tree_leaves, tree_map)
from .schedule import warmup_cosine

__all__ = ["Trainer", "TrainerConfig"]

#: ExecutionPlan knobs that only a mesh reads
MESH_KNOBS = ("fsdp_params", "pure_dp", "grad_compression")


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


def _map_leaves(fn, tree, extra: list):
    """``fn(leaf, x)`` over the leaves of a tree of dicts and lists in
    ``tree_leaves``' order (dict keys sorted), ``x`` the matching item of
    ``extra``."""
    it = iter(extra)

    def visit(t):
        if isinstance(t, dict):
            return {k: visit(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [visit(v) for v in t]
        return fn(t, next(it))

    return visit(tree)


@dataclasses.dataclass
class _Leaf:
    """How one parameter's gradient is reduced and updated over the mesh:
    the axes its FSDP gather sums the gradient over in the backward, the
    axes still to reduce it over, the ZeRO cut of its optimizer state
    (dimension and axes, or ``None``) and the axes its optimizer slice is
    sharded on (the norm's group)."""
    gathered: Tuple[str, ...]
    rest: Tuple[str, ...]
    zdim: Optional[int]
    zaxes: Tuple[str, ...]
    norm_axes: Tuple[str, ...]


class Trainer:
    """Trains ``cfg`` on ``shape``'s synthetic batches on ``device``
    (default: the card), over ``mesh`` when one is given. Raises
    ``NotImplementedError`` for a config with Mamba or xLSTM layers or MoE
    MLPs (ROADMAP §1, item 3.2b)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec,
                 tcfg: TrainerConfig = TrainerConfig(),
                 ocfg: AdamWConfig = AdamWConfig(),
                 mesh=None, plan: ExecutionPlan = ExecutionPlan(),
                 data_axes=("data",), model_axis: str = "model",
                 device=None):
        check_trainable(cfg)
        self.cfg = plan.apply(cfg)
        self.shape = shape
        self.tcfg, self.ocfg, self.plan = tcfg, ocfg, plan
        self.device = resolve_device(device)
        self.data = SyntheticData(self.cfg, shape, seed=tcfg.seed,
                                  device=self.device)
        self.straggler_events: List[Dict[str, float]] = []
        self.mesh, self.ctx = mesh, None
        if mesh is None:
            knobs = [k for k in MESH_KNOBS if getattr(plan, k)]
            if knobs:
                raise ValueError(f"{', '.join(knobs)}: these knobs need a "
                                 f"mesh")
            return
        self._build(mesh, tuple(data_axes), model_axis)

    # -- the mesh layout ------------------------------------------------------
    def _build(self, mesh, data_axes: Tuple[str, ...], model_axis: str):
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh, "
                            f"not {type(mesh).__name__}")
        names = tuple(mesh.mesh_dim_names or ())
        missing = [a for a in data_axes + (model_axis,) if a not in names]
        if missing:
            raise ValueError(f"axes {missing} are not in the mesh {names}")
        if mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot train on "
                             f"{self.device}")
        cfg, plan = self.cfg, self.plan
        # pure_dp: the whole mesh is one data/FSDP domain (the reference's
        # dry run widens its data axes the same way)
        batch_axes = tuple(dict.fromkeys(
            data_axes + ((model_axis,) if plan.pure_dp else ())))
        ctx = MeshContext(mesh, data_axes, model_axis)
        n_model = ctx.size(model_axis)
        n_batch = ctx.size(batch_axes)
        if self.shape.global_batch % n_batch:
            raise ValueError(f"the global batch of {self.shape.global_batch} "
                             f"does not divide over {n_batch} data ranks")
        shapes = init_params(cfg, None)
        specs = param_specs(shapes, cfg, plan, model_axis=model_axis,
                            data_axes=data_axes, n_model=n_model)
        if not plan.pure_dp:
            specs = kv_whole_specs(specs, cfg, model_axis, n_model)
        ospecs = map_specs(lambda sp, leaf: opt_state_spec_for(
            sp, tuple(leaf.shape), batch_axes, mesh), specs, shapes)
        ctx.specs = specs
        self.ctx, self.batch_axes, self.n_batch = ctx, batch_axes, n_batch
        self.shardings = dict(
            params=to_shardings(specs, ctx), opt=to_shardings(ospecs, ctx),
            batch=to_shardings(batch_specs(cfg, self.shape, batch_axes), ctx))
        self._shapes = shapes

        def leaf(spec, ospec):
            gathered = tuple(a for e in spec if e != model_axis
                             for a in _axes(e))
            zdim = next((d for d, (e, o) in enumerate(zip(spec, ospec))
                         if e is None and o is not None), None)
            return _Leaf(gathered,
                         tuple(a for a in batch_axes if a not in gathered),
                         zdim, _axes(ospec[zdim]) if zdim is not None else (),
                         tuple(a for e in ospec for a in _axes(e)))

        self._leaves = tree_leaves(map_specs(leaf, specs, ospecs))
        # each leaf's compression residual (plan.grad_compression), made at
        # its first reduction
        self._err: List[Optional[torch.Tensor]] = [None] * len(self._leaves)

    @property
    def lead(self) -> bool:
        """True on the rank that logs and writes checkpoints."""
        return self.ctx is None or torch.distributed.get_rank() == 0

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Step ``step``'s batch: the global batch, or this rank's rows of
        it over a mesh."""
        batch = self.data.batch(step)
        if self.ctx is None:
            return batch
        sh = self.shardings["batch"]
        return {k: sh[k].shard(v).contiguous() for k, v in batch.items()}

    def from_logical(self, params, opt):
        """This rank's shards of logical parameters and optimizer state
        (laid out as on one device), on the trainer's device; the
        parameters require gradients."""
        if self.ctx is not None:
            sh = self.shardings
            params = map_specs(lambda s, t: s.shard(t).contiguous(),
                                sh["params"], params)
            opt = dict(opt, **{k: map_specs(
                lambda s, t: s.shard(t).contiguous(), sh["opt"], opt[k])
                for k in ("master", "m", "v")})
        params = tree_map(lambda t: t.detach().to(self.device)
                          .requires_grad_(True), params)
        opt = tree_map(lambda t: t.to(self.device), opt)
        return params, opt

    def logical(self, params, opt):
        """The logical parameters and optimizer state gathered from every
        rank's shards (a collective over the mesh)."""
        if self.ctx is None:
            return params, opt
        with torch.no_grad():
            sh = self.shardings
            params = map_specs(lambda s, t: s.gather(t.detach()),
                                sh["params"], params)
            opt = dict(opt, **{k: map_specs(lambda s, t: s.gather(t),
                                             sh["opt"], opt[k])
                               for k in ("master", "m", "v")})
        return params, opt

    # -- state init / restore -------------------------------------------------
    def init_state(self):
        """Seeded parameters (requiring gradients) and a fresh optimizer
        state: this rank's shards of them over a mesh."""
        params = init_params(self.cfg, torch.Generator(
            device=self.device).manual_seed(self.tcfg.seed))
        if self.ctx is None:
            tree_map(lambda p: p.requires_grad_(True), params)
            return params, init_opt_state(params)
        return self.from_logical(params, init_opt_state(params))

    def try_restore(self, params, opt):
        step = latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return 0, params, opt
        if self.ctx is None:
            _, trees, _ = restore_checkpoint(
                self.tcfg.ckpt_dir, {"params": params, "opt": opt})
            params, opt = trees["params"], trees["opt"]
            tree_map(lambda p: p.requires_grad_(True), params)
        else:
            _, trees, _ = restore_checkpoint(
                self.tcfg.ckpt_dir, {"params": self._shapes,
                                     "opt": init_opt_state(self._shapes)},
                step=step, device=self.device)
            params, opt = self.from_logical(trees["params"], trees["opt"])
        if self.lead:
            print(f"[trainer] restored checkpoint at step {step}")
        return step, params, opt

    def save(self, step: int, params, opt) -> None:
        """Checkpoint ``step``: logical arrays, written by rank 0, the
        other ranks waiting at a barrier until the write is published."""
        params, opt = self.logical(params, opt)
        if self.lead:
            save_checkpoint(self.tcfg.ckpt_dir, step,
                            {"params": params, "opt": opt},
                            keep_last=self.tcfg.keep_last)
        if self.ctx is not None:
            torch.distributed.barrier(
                group=self.ctx.group(tuple(self.mesh.mesh_dim_names)))

    # -- the step ---------------------------------------------------------
    def gradients(self, params, batch):
        """The loss of ``batch`` and its gradient: (metrics, grads) with the
        metrics as 0-d tensors (loss, ce, aux), not synced, and the
        gradients laid out like ``params``. Over a mesh the gradients are
        those of the mean loss over the data axes, each on this rank's
        shard, and the reported loss is that mean."""
        tree_map(lambda p: setattr(p, "grad", None), params)
        if self.ctx is None:
            loss, metrics = loss_fn(self.cfg, params, batch)
            loss.backward()
            grads = tree_map(lambda p: p.grad, params)
        else:
            with mesh_context(self.ctx):
                loss, metrics = loss_fn(self.cfg, params, batch)
            loss.backward()
            grads = self._reduce(params)
            vals = dict(loss=loss, **metrics)
            mean = C.all_reduce(torch.stack([v.detach().float().reshape(())
                                             for v in vals.values()]),
                                self.ctx.group(self.batch_axes)
                                ) / self.n_batch
            loss, metrics = mean[0], dict(zip(list(vals)[1:], mean[1:]))
        tree_map(lambda p: setattr(p, "grad", None), params)
        return {k: v.detach() for k, v in dict(loss=loss, **metrics).items()
                }, grads

    @torch.no_grad()
    def _reduce(self, params):
        """Each leaf's gradient averaged over the data axes: summed by its
        FSDP reduce-scatter over the axes it was gathered on, all-reduced
        (or compressed) over the rest, the leaves of one set of axes packed
        together."""
        ctx, n = self.ctx, self.n_batch
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in tree_leaves(params)]
        groups: Dict[Tuple[str, ...], List[int]] = {}
        for i, lf in enumerate(self._leaves):
            if lf.rest:
                groups.setdefault(lf.rest, []).append(i)
        means = set()
        for rest, idx in groups.items():
            if not self.plan.grad_compression:
                # in place: the gradient buffers are the trainer's own
                C.all_reduce_coalesced([grads[i] for i in idx],
                                       ctx.group(rest))
                continue
            errs = [self._err[i] if self._err[i] is not None else
                    torch.zeros(grads[i].shape, dtype=torch.float32,
                                device=grads[i].device) for i in idx]
            mean, errs = compressed_psum([grads[i] for i in idx], errs,
                                         ctx.group(rest))
            for i, m, e in zip(idx, mean, errs):
                self._err[i] = e
                grads[i] = (m / ctx.size(self._leaves[i].gathered)).to(
                    grads[i].dtype)
                means.add(i)
        for i, g in enumerate(grads):
            if i not in means:
                g.div_(n)
        return _map_leaves(lambda _, g: g, params, grads)

    def _zero_slice(self, t: torch.Tensor, lf: _Leaf) -> torch.Tensor:
        if lf.zdim is None:
            return t
        w = t.shape[lf.zdim] // self.ctx.size(lf.zaxes)
        return t.narrow(lf.zdim, self.ctx.index(lf.zaxes) * w, w)

    @torch.no_grad()
    def _global_norm(self, zgrads) -> torch.Tensor:
        """√ of the logical gradient's squares: each leaf's slice summed
        over the axes its optimizer slice is sharded on."""
        parts: Dict[Tuple[str, ...], torch.Tensor] = {}
        for g, lf in zip(tree_leaves(zgrads), self._leaves):
            sq = torch.sum(torch.square(g.float()))
            parts[lf.norm_axes] = parts.get(lf.norm_axes, 0) + sq
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for axes, sq in parts.items():
            sq = torch.as_tensor(sq, dtype=torch.float32,
                                 device=self.device).reshape(1)
            if axes:
                C.all_reduce(sq, self.ctx.group(axes))
            total = total + sq[0]
        return torch.sqrt(total)

    def apply_gradients(self, params, opt, grads, step: int):
        """AdamW on ``grads`` at ``step``'s learning rate: in place, on
        this rank's ZeRO slices, the parameters then all-gathered over the
        ZeRO axes. Returns (params, opt, {"grad_norm"})."""
        lr_scale = warmup_cosine(step, warmup_steps=self.tcfg.warmup_steps,
                                 total_steps=self.tcfg.total_steps)
        if self.ctx is None:
            return adamw_update(grads, opt, params, self.ocfg, lr_scale)
        with torch.no_grad():
            zgrads = _map_leaves(self._zero_slice, grads, self._leaves)
            zparams = _map_leaves(self._zero_slice, params, self._leaves)
            gnorm = self._global_norm(zgrads)
            adamw_update(zgrads, opt, zparams, self.ocfg, lr_scale,
                         gnorm=gnorm)
            ps, zs = tree_leaves(params), tree_leaves(zparams)
            groups: Dict[Tuple[str, ...], List[int]] = {}
            for i, lf in enumerate(self._leaves):
                if lf.zdim is not None:
                    groups.setdefault(lf.zaxes, []).append(i)
            for axes, idx in groups.items():
                full = C.all_gather_coalesced(
                    [zs[i] for i in idx], [self._leaves[i].zdim for i in idx],
                    self.ctx.group(axes))
                for i, f in zip(idx, full):
                    ps[i].copy_(f)
        return params, opt, dict(grad_norm=gnorm)

    def step(self, params, opt, batch, step: int):
        """One optimizer step on ``batch`` (this rank's rows over a mesh:
        :meth:`batch`): the loss and its gradient, the learning-rate scale
        at ``step``, AdamW. Updates ``params`` and ``opt`` in place;
        returns (params, opt, metrics) with the metrics as 0-d tensors
        (loss, ce, aux, grad_norm), not synced."""
        metrics, grads = self.gradients(params, batch)
        params, opt, om = self.apply_gradients(params, opt, grads, step)
        metrics = dict(metrics, **{k: v.detach() for k, v in om.items()})
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
            batch = self.batch(step)
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
            if step % self.tcfg.log_every == 0 and self.lead:
                print(f"[trainer] step {step} loss={metrics['loss']:.4f} "
                      f"({dt*1e3:.0f} ms)")
            step += 1
            if step % self.tcfg.ckpt_every == 0 or step == steps:
                self.save(step, params, opt)
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
