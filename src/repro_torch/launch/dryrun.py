"""Port of ``repro/launch/dryrun.py``: ``cell_is_applicable`` (:45),
``build_cell`` (:55), ``run_cell`` (:151) and ``main`` (:275), the dry run
of every (arch × shape) cell on rank 0 of the production mesh, with its
roofline record.

The reference lowers and compiles each cell for 256 or 512 placeholder
XLA devices and reads the compiled module. Here rank 0 runs the cell's
own code, eagerly, with nothing on any device:

* **The ranks.** A ``fake`` process group of 256 (``pod16x16``) or 512
  (``pod2x16x16``) ranks with this process as rank 0
  (:func:`repro_torch.launch.mesh.fake_ranks`), and the production mesh
  over it: its collectives return at once and are counted as on the card.
* **The tensors.** Inside :class:`repro_torch.device.dry_run`, every
  parameter, optimizer slot, batch and cache is a ``meta`` tensor of rank
  0's shard shape, made from the specs the trainer and the serving path
  lay them out by. A meta tensor has a shape and a dtype and no storage,
  and there it takes the card's branches (the attention kernels' wrappers
  apply their shape rule and launch nothing). Any other tensor in the
  trace fails the cell: nothing real takes part.
* **The call.** A train cell runs ``Trainer.step`` (loss, backward, the
  gradient reduction, AdamW: the reference's jitted step), not ``run``,
  whose ``float()`` would read a value. A prefill cell runs ``prefill``, a
  decode cell one ``decode_step`` against a full cache (position
  ``seq_len − 1``) under ``decode_seq_axes_for``, as the reference's
  ``build_cell`` does.
* **The count.** :class:`repro_torch.launch.op_analysis.OpCount` around
  the call gives the record's ``hlo`` and the live bytes.

Why meta tensors and not ``FakeTensorMode``'s CUDA-typed fake tensors: on
a PyTorch built without CUDA (the CPU hosts the dry run is for), autograd
asks the CUDA device guard for a stream when it records a fake CUDA leaf,
and the process aborts; meta tensors differentiate anywhere.

The record keeps the reference's keys. ``memory``: ``argument`` is the
rank's parameters, optimizer state, batch and cache; ``temp`` the peak of
live bytes the call allocated (its outputs included); ``alias`` what it
updates in place (parameters and optimizer state for a train cell, the
cache for a decode cell); ``output`` the bytes of what it returns; ``code``
0. ``resident_bytes`` is ``argument + temp``, the predicted peak, and
``fits_hbm`` compares it with the card's memory. The roofline's terms
divide the rank's dot FLOPs, dot bytes and collective bytes by the card's
rates (:data:`repro_torch.device.PEAK_BF16_FLOPS`, ``HBM_BYTES_PER_S``,
``NVLINK_BYTES_PER_S``: a 16 × 16 mesh of H100s crosses nodes, so the
collective term is a lower bound).

Statuses other than ``ok``: ``skipped: …`` (``cell_is_applicable``),
``cannot run: …`` (a decode whose cache's sequence is split while
``seq_shard_decode`` is off: the reference lets GSPMD gather the cache,
which the port never does), ``over its time limit: …`` and ``FAILED: …``;
each is written, not dropped, and the plan selector scores them as
infinite. One process may run many cells (``--all``); each gets a fresh
fake group.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
        --shape train_4k [--multi-pod] [--plan-json '{"fsdp_params": true}']
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

Per cell it writes ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>[__tag]
.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import signal
import threading
import time
import traceback
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ..configs import ARCH_NAMES, get_config
from ..device import (CARD, HBM_BYTES, HBM_BYTES_PER_S, NVLINK_BYTES_PER_S,
                      PEAK_BF16_FLOPS, dry_run)
from ..distributed.meshctx import MeshContext, mesh_context
from ..distributed.sharding import (ExecutionPlan, Sharding, _batch_split,
                                    attn_dp_axes_for, cache_specs,
                                    decode_seq_axes_for, kv_whole_specs,
                                    map_specs, param_specs, to_shardings)
from ..models.config import SHAPES, ModelConfig, ShapeSpec
from ..models.transformer import (decode_step, init_cache, init_params,
                                  prefill)
from ..train.data import input_specs
from ..train.optimizer import init_opt_state, tree_leaves
from ..train.trainer import Trainer
from .mesh import fake_ranks, make_mesh, mesh_axes
from .op_analysis import OpCount, tensor_bytes

__all__ = ["cell_is_applicable", "build_cell", "trace_cell", "run_cell",
           "Cell", "CannotRun", "main", "DEFAULT_OUT_DIR", "TIME_LIMIT_S"]

DEFAULT_OUT_DIR = "artifacts/dryrun_torch"
#: a cell's trace is cut after this many seconds (and recorded as such)
TIME_LIMIT_S = 900.0


class CannotRun(ValueError):
    """A cell the port cannot run as planned."""


def cell_is_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """Returns a skip reason or None."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("skipped: pure full-attention arch — 500k-token decode is "
                "reserved for sub-quadratic (SSM/hybrid) archs per the "
                "assignment (see DESIGN.md §Arch-applicability)")
    return None


@dataclasses.dataclass
class Cell:
    """Rank 0's call for one cell: ``fn()`` runs it; ``argument`` and
    ``alias`` are the bytes of its inputs and of those it updates in
    place."""
    fn: Callable[[], Any]
    argument: int
    alias: int


def _meta(sharding: Sharding, shape, dtype) -> torch.Tensor:
    """A meta tensor of this rank's shard of a ``shape`` laid out by
    ``sharding``."""
    shape = list(shape)
    for d, axes in sharding._dims():
        n = sharding.ctx.size(axes)
        if shape[d] % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split over {n} ranks of {axes}")
        shape[d] //= n
    return torch.empty(shape, dtype=dtype, device="meta")


def _shards(shardings, like, dtype=None):
    return map_specs(lambda sh, t: _meta(sh, t.shape, dtype or t.dtype),
                     shardings, like)


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               data_axes: Tuple[str, ...], model_axis: str,
               plan: ExecutionPlan) -> Cell:
    """Rank 0's call for the cell over ``mesh`` (a mesh of the dry run's
    fake group, inside :class:`repro_torch.device.dry_run`), its leaves
    meta tensors of their shard shapes. Raises :class:`CannotRun` for a
    decode the port cannot run under ``plan``."""
    data_axes = tuple(data_axes)
    if shape.kind == "train":
        t = Trainer(cfg, shape, mesh=mesh, plan=plan, data_axes=data_axes,
                    model_axis=model_axis)
        sh = t.shardings
        params = _shards(sh["params"], t._shapes)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        slots = init_opt_state(t._shapes)
        opt = {k: _shards(sh["opt"], slots[k], torch.float32)
               for k in ("master", "m", "v")}
        opt["count"] = torch.zeros((), dtype=torch.int32, device="meta")
        batch = {k: _meta(sh["batch"][k], v.shape, v.dtype)
                 for k, v in input_specs(t.cfg, shape).items()}
        return Cell(lambda: t.step(params, opt, batch, 0),
                    tensor_bytes((params, opt, batch)),
                    tensor_bytes((params, opt)))

    cfg = plan.apply(cfg)
    if plan.pure_dp:
        # flat DP/FSDP over every mesh axis, as the reference's dry run
        data_axes = tuple(dict.fromkeys(data_axes + (model_axis,)))
    ctx = MeshContext(mesh, data_axes, model_axis,
                      shard_activation_ckpt=plan.shard_activation_ckpt)
    n_model = ctx.size(model_axis)
    ctx.attn_dp_axes = attn_dp_axes_for(cfg, plan, data_axes, model_axis,
                                        n_model)
    shapes = init_params(cfg, None)
    specs = param_specs(shapes, cfg, plan, model_axis=model_axis,
                        data_axes=data_axes, n_model=n_model)
    if not plan.pure_dp:
        specs = kv_whole_specs(specs, cfg, model_axis, n_model)
    ctx.specs = specs
    ctx.cache_specs = cache_specs(cfg, shape, mesh, model_axis=model_axis,
                                  data_axes=data_axes)
    params = _shards(to_shardings(specs, ctx), shapes)
    split = _batch_split(shape.global_batch, ctx.size(data_axes))
    da = data_axes if len(data_axes) > 1 else data_axes[0]
    rows = Sharding(ctx, (da,) if split else (None,))

    def local(k, v):
        return _meta(Sharding(ctx, (None,) + rows.spec) if k == "positions3"
                     else rows, v.shape, v.dtype)

    batch = {k: local(k, v) for k, v in input_specs(cfg, shape).items()}
    if shape.kind == "prefill":
        def run():
            with mesh_context(ctx), torch.no_grad():
                return prefill(cfg, params, batch, max_seq=shape.seq_len)
        return Cell(run, tensor_bytes((params, batch)), 0)

    try:
        ctx.decode_seq_axes = decode_seq_axes_for(
            cfg, shape, mesh, plan, model_axis=model_axis,
            data_axes=data_axes)
    except ValueError as e:
        raise CannotRun(str(e)) from e
    with mesh_context(ctx):
        cache = init_cache(cfg, shape.global_batch, shape.seq_len)
    cache["pos"] = shape.seq_len - 1  # one token against a full cache
    tokens = next(iter(batch.values()))

    def step():
        with mesh_context(ctx), torch.no_grad():
            return decode_step(cfg, params, cache, tokens)
    return Cell(step, tensor_bytes((params, cache, tokens)),
                tensor_bytes(cache))


def trace_cell(cell: Cell) -> dict:
    """Run ``cell`` under :class:`OpCount`; the measurements of the record
    (``memory``, ``hlo``, the seconds, the devices its tensors were on).
    Raises if a tensor of the call was not a meta tensor."""
    t0 = time.perf_counter()
    with OpCount() as oc:
        out = cell.fn()
    secs = time.perf_counter() - t0
    results = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    real = {d: op for d, op in oc.devices.items() if d != "meta"}
    real.update({t.device.type: "a result" for t in results
                 if t.device.type != "meta" and t.numel() > 1})
    if real:
        raise RuntimeError(f"the dry run touched real tensors: "
                           + ", ".join(f"{d} (first: {op})"
                                       for d, op in sorted(real.items())))
    devices = set(oc.devices) | {t.device.type for t in results
                                 if t.numel() > 1}
    memory = dict(argument=cell.argument, output=tensor_bytes(out),
                  temp=oc.peak_bytes, alias=cell.alias, code=0)
    return dict(t_trace_s=secs, memory=memory, hlo=oc.stats(),
                kernel_calls=dict(oc.kernel_calls), devices=sorted(devices))


@contextlib.contextmanager
def _time_limit(seconds: float):
    """Raise ``TimeoutError`` in the block after ``seconds`` (the main
    thread only: elsewhere there is no limit)."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def alarm(signum, frame):
        raise TimeoutError(f"over {seconds:g} s")

    old = signal.signal(signal.SIGALRM, alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _mesh(multi_pod: bool, mesh_shape: Optional[Sequence[int]]):
    """(name, shape, axes) of the cell's mesh."""
    if mesh_shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        name = "pod2x16x16" if multi_pod else "pod16x16"
    else:
        shape = tuple(int(n) for n in mesh_shape)
        name = "mesh" + "x".join(map(str, shape))
    data_axes, model_axis = mesh_axes(len(shape) == 3)
    return name, shape, data_axes + (model_axis,)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             plan: ExecutionPlan = ExecutionPlan(),
             out_dir: str = DEFAULT_OUT_DIR, tag: str = "",
             verbose: bool = True, *,
             mesh_shape: Optional[Sequence[int]] = None,
             global_batch: Optional[int] = None) -> dict:
    """Dry-run one cell on rank 0 and write its record (module docstring).
    ``mesh_shape`` replaces the production mesh with a (data, model) or
    (pod, data, model) mesh of that shape (named ``mesh<d>x<m>``);
    ``global_batch`` cuts the shape's batch (recorded in ``reduced``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name, dims, axes = _mesh(multi_pod, mesh_shape)
    os.makedirs(os.path.join(out_dir, mesh_name), exist_ok=True)
    out_path = os.path.join(
        out_dir, mesh_name,
        f"{arch}__{shape_name}{('__' + tag) if tag else ''}.json")

    record: dict = dict(arch=arch, shape=shape_name, mesh=mesh_name,
                        plan=dataclasses.asdict(plan),
                        model_params=cfg.param_count(),
                        active_params=cfg.active_param_count(), card=CARD)
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=int(global_batch))
        record["reduced"] = dict(global_batch=shape.global_batch)
    skip = cell_is_applicable(cfg, shape)
    if skip:
        record["status"] = skip
        _write(out_path, record)
        if verbose:
            print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: {skip}")
        return record

    n_chips = math.prod(dims)
    t0 = time.perf_counter()
    try:
        with dry_run(), fake_ranks(n_chips), _time_limit(TIME_LIMIT_S):
            mesh = make_mesh(dims, axes)
            cell = build_cell(cfg, shape, mesh, axes[:-1], axes[-1], plan)
            got = trace_cell(cell)
        record.update(status="ok", n_chips=n_chips,
                      **_roofline(cfg, shape, got, n_chips))
        if verbose:
            r = record["roofline"]
            print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: OK "
                  f"(trace {got['t_trace_s']:.1f}s, resident "
                  f"{record['resident_bytes'] / 1e9:.2f} GB/dev, "
                  f"bottleneck {r['bottleneck']})")
    except CannotRun as e:
        record["status"] = f"cannot run: {e}"
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        secs = time.perf_counter() - t0
        if secs >= TIME_LIMIT_S:
            record["status"] = (f"over its time limit: {secs:.0f} s of "
                                f"{TIME_LIMIT_S:g}")
        else:
            record["status"] = f"FAILED: {type(e).__name__}: {e}"
            record["traceback"] = traceback.format_exc()[-4000:]
    if verbose and record["status"] != "ok":
        print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: "
              f"{record['status']}")
    _write(out_path, record)
    return record


def _roofline(cfg: ModelConfig, shape: ShapeSpec, got: dict,
              n_chips: int) -> dict:
    """The record's measured part: memory, the op count, the roofline."""
    mem, hlo = got["memory"], got["hlo"]
    resident = mem["argument"] + mem["temp"]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * cfg.active_param_count() * tokens
    terms = dict(compute_s=hlo.dot_flops / PEAK_BF16_FLOPS,
                 memory_s=hlo.dot_bytes / HBM_BYTES_PER_S,
                 collective_s=hlo.total_collective_bytes / NVLINK_BYTES_PER_S)
    flops_global = hlo.dot_flops * n_chips
    return dict(
        t_trace_s=round(got["t_trace_s"], 1), memory=mem,
        resident_bytes=int(resident), fits_hbm=bool(resident < HBM_BYTES),
        hlo=hlo.to_json(), kernel_calls=got["kernel_calls"],
        devices=got["devices"],
        per_device=dict(dot_flops=hlo.dot_flops, bytes=hlo.dot_bytes,
                        dot_bytes=hlo.dot_bytes,
                        touched_bytes=hlo.touched_bytes,
                        collective_bytes=hlo.total_collective_bytes),
        roofline=dict(**terms, bottleneck=max(terms, key=terms.get),
                      model_flops=model_flops,
                      hlo_flops_global=flops_global,
                      useful_flops_ratio=(model_flops / flops_global
                                          if flops_global else 0.0)))


def _write(path: str, record: dict) -> None:
    with open(path, "w") as f:
        json.dump(record, f, indent=2)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCH_NAMES)
    p.add_argument("--shape", choices=list(SHAPES))
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--all", action="store_true",
                   help="run every (arch × shape) for the selected mesh")
    p.add_argument("--plan-json", default="",
                   help='ExecutionPlan overrides, e.g. \'{"fsdp_params":true}\'')
    p.add_argument("--tag", default="", help="artifact suffix for perf exps")
    p.add_argument("--out-dir", default=DEFAULT_OUT_DIR)
    args = p.parse_args(argv)

    plan = ExecutionPlan(**json.loads(args.plan_json)) if args.plan_json \
        else ExecutionPlan()
    cells = ([(a, s) for a in ARCH_NAMES for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    if not args.all and not (args.arch and args.shape):
        p.error("--arch/--shape or --all required")
    for arch, shape_name in cells:
        run_cell(arch, shape_name, args.multi_pod, plan, args.out_dir,
                 args.tag)


if __name__ == "__main__":
    main()
