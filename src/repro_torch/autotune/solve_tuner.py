"""Port of ``repro/autotune/solve_tuner.py``: the autotuned bucket/block
policy of the numeric solve backends.

The level-scheduled backends (``batched`` / ``pipelined``) have two
device-dependent knobs:

* ``bs`` — the panel-width cap of the batched partial-Cholesky kernel
  (:func:`repro_torch.kernels.ops.pick_block_size`, which caps it in turn
  at the kernels' 32 columns, so ``bs=64`` runs the panels of 32);
* ``pad`` — the schedule's bucket pad policy
  (:data:`repro_torch.sparse.schedule.PAD_POLICIES`): ``pow2`` gives fewer
  bucket widths, ``mult8`` fewer padded FLOPs.

and the device sweeps two more: ``sweep_bs`` (the tri-solve panel cap) and
``rt`` (the RHS tile). :func:`tune` *measures*: it times warm
factorizations of a small suite over the candidate grid (stage 1), then
warm multi-RHS device solves over the sweep grid (stage 2), and persists
the winner per **device kind** — ``torch.cuda.get_device_name`` on the
card, ``"cpu"`` for the CPU — as ``solve_policy_torch_<kind>.json`` under
``artifacts/autotune_torch/``. The file name and directory are the port's
own: a policy the reference measured under JAX (its
``solve_policy_<kind>.json`` under ``artifacts/autotune/``) is never read
here, so numbers measured under other rules are a miss, not served.

Every timed call ends in a sync on the card: the pipelined factor drains
the stream before it returns, and the sweeps return NumPy arrays.

Staleness rules are the reference's: a persisted policy records the schema
version, device kind and backend it was tuned for; :func:`load_policy`
rejects records that mismatch any of them, name an unknown pad policy or
do not parse. Delete the JSON (or pass ``force=True`` to
:func:`get_policy`) to re-measure.

The engine threads the policy through
:class:`repro_torch.engine.config.EngineConfig` (``autotune_solve`` /
``autotune_dir``) into :func:`repro_torch.core.plan.execute_plan`, which
records the applied knobs in ``ExecutionPlan.meta["solve_bs"/"solve_pad"]``.

Beyond the reference: :func:`device_kind`, :func:`tune` and
:func:`get_policy` take the device explicitly (``device=None`` is the
card), and :func:`tune` reports each candidate's summed best warm time to
an optional ``on_candidate`` callback.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..sparse.schedule import PAD_POLICIES

__all__ = ["SolvePolicy", "DEFAULT_AUTOTUNE_DIR", "device_kind",
           "policy_path", "load_policy", "save_policy", "seed_order",
           "tune", "get_policy"]

SCHEMA = 1
DEFAULT_AUTOTUNE_DIR = os.path.join("artifacts", "autotune_torch")

#: default candidate grid: panel-width caps × pad policies
DEFAULT_BS_GRID: Tuple[Optional[int], ...] = (16, 32, 64)
#: stage-2 grid: device-sweep tri-solve panel caps × RHS tile widths
DEFAULT_SWEEP_BS_GRID: Tuple[Optional[int], ...] = (None, 16)
DEFAULT_RT_GRID: Tuple[Optional[int], ...] = (None, 8)


@dataclasses.dataclass(frozen=True)
class SolvePolicy:
    """One (device kind, backend)'s tuned bucket/block policy."""

    bs: Optional[int] = None     # panel-width cap (None = kernel default)
    pad: str = "pow2"            # bucket pad policy
    device_kind: str = ""        # device kind the numbers came from
    backend: str = "batched"     # backend the timing loop ran
    warm_factor_s: float = 0.0   # best measured warm factor time (suite sum)
    source: str = "default"      # "default" | "tuned" | "cached"
    # device-sweep knobs (sweep="device"): tri-solve panel cap and RHS
    # tile width, measured in the stage-2 grid over warm multi-RHS solves
    # (None = kernel defaults; absent in pre-sweep records, defaulted on
    # load)
    sweep_bs: Optional[int] = None
    rt: Optional[int] = None
    warm_sweep_s: float = 0.0    # best measured warm device-solve time

    def to_json(self) -> dict:
        return dict(schema=SCHEMA, **dataclasses.asdict(self))

    @classmethod
    def from_json(cls, doc: dict) -> "SolvePolicy":
        doc = {k: v for k, v in doc.items() if k != "schema"}
        return cls(**doc)


def device_kind(device=None) -> str:
    """The device kind policies are keyed by: the card's name
    (``torch.cuda.get_device_name``) for a CUDA device, ``"cpu"`` for the
    CPU. ``None`` is the card (raising when there is none)."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(dev)


def _slug(kind: str) -> str:
    return re.sub(r"[^a-z0-9]+", "-", kind.lower()).strip("-") or "unknown"


def policy_path(dirpath: str, kind: str) -> str:
    return os.path.join(dirpath, f"solve_policy_torch_{_slug(kind)}.json")


def save_policy(policy: SolvePolicy,
                dirpath: str = DEFAULT_AUTOTUNE_DIR) -> str:
    os.makedirs(dirpath, exist_ok=True)
    path = policy_path(dirpath, policy.device_kind)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(policy.to_json(), fh, indent=2)
    os.replace(tmp, path)
    return path


def load_policy(dirpath: str, kind: str,
                backend: Optional[str] = None) -> Optional[SolvePolicy]:
    """The persisted policy for ``kind``, or None if absent/stale.

    Stale = schema or device-kind mismatch, unknown pad policy, or (when
    ``backend`` is given) a record tuned for a different backend — all
    treated as a miss so the caller re-tunes rather than serving numbers
    measured under different rules.
    """
    path = policy_path(dirpath, kind)
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None
    if doc.get("schema") != SCHEMA or doc.get("device_kind") != kind:
        return None
    if doc.get("pad") not in PAD_POLICIES:
        return None
    if backend is not None and doc.get("backend") != backend:
        return None
    try:
        return dataclasses.replace(SolvePolicy.from_json(doc),
                                   source="cached")
    except TypeError:
        return None


def seed_order(bench_path: str = "BENCH_solve.json",
               pads: Sequence[str] = PAD_POLICIES) -> List[str]:
    """Pad-policy candidate ordering seeded from benchmark rooflines.

    A ``BENCH_solve.json``-shaped file records the realized bucket
    occupancy per matrix. When the suite's mean occupancy is high, padding
    waste is not the bottleneck — try ``pow2`` first. Low occupancy (< 0.5)
    means padded-FLOP waste — try ``mult8`` first. Without a readable file
    the declared order stands.
    """
    pads = [p for p in pads if p in PAD_POLICIES]
    try:
        with open(bench_path) as fh:
            doc = json.load(fh)
        occ = [r["occupancy"] for r in doc.get("records", [])
               if "occupancy" in r]
        mean_occ = float(np.mean(occ)) if occ else 1.0
    except (OSError, json.JSONDecodeError, KeyError):
        return list(pads)
    if mean_occ < 0.5 and "mult8" in pads:
        return ["mult8"] + [p for p in pads if p != "mult8"]
    return list(pads)


def _default_suite():
    from ..sparse.dataset import block_arrow, grid2d

    rng = np.random.default_rng(0)
    return [grid2d(12, 12, "tune_grid"),
            block_arrow(3, 20, 8, rng, "tune_arrow")]


def _best_warm(fn, repeats: int) -> float:
    """One cold call, then the best of ``repeats`` timed warm calls."""
    fn()
    best = float("inf")
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def tune(mats=None, *, backend: str = "pipelined",
         bs_grid: Sequence[Optional[int]] = DEFAULT_BS_GRID,
         pads: Optional[Sequence[str]] = None, repeats: int = 2,
         sweep_bs_grid: Sequence[Optional[int]] = DEFAULT_SWEEP_BS_GRID,
         rt_grid: Sequence[Optional[int]] = DEFAULT_RT_GRID,
         bench_path: str = "BENCH_solve.json",
         out_dir: Optional[str] = DEFAULT_AUTOTUNE_DIR, device=None,
         on_candidate: Optional[Callable[[str, tuple, float], None]] = None
         ) -> SolvePolicy:
    """Measure the candidate grid on ``device`` and persist the winner.

    Stage 1, per (pad, bs): one cold factor + solve then ``repeats`` warm
    ones of every suite matrix; the score is the summed best warm time.
    Stage 2 re-factors once with the stage-1 winner and grids the
    device-sweep knobs (tri-solve panel cap × RHS tile) over warm
    four-RHS ``mode="device"`` solves. ``out_dir=None`` skips persistence.
    ``on_candidate(stage, key, seconds)`` hears every candidate's score
    (stage ``"factor"`` with key ``(pad, bs)``, ``"sweep"`` with
    ``(sweep_bs, rt)``).
    """
    from ..sparse.multifrontal import (factor_and_solve_timed,
                                       multifrontal_cholesky,
                                       multifrontal_solve)
    from ..sparse.symbolic import symbolic_cholesky

    if mats is None:
        mats = _default_suite()
    pads = seed_order(bench_path, PAD_POLICIES if pads is None else pads)
    syms = [symbolic_cholesky(a) for a in mats]
    kind = device_kind(device)
    results: Dict[Tuple[str, Optional[int]], float] = {}
    for pad in pads:
        for bs in bs_grid:
            results[(pad, bs)] = sum(
                _best_warm(lambda a=a, sym=sym: factor_and_solve_timed(
                    a, sym=sym, backend=backend, pad=pad, bs=bs,
                    device=device), repeats)
                for a, sym in zip(mats, syms))
            if on_candidate is not None:
                on_candidate("factor", (pad, bs), results[(pad, bs)])
    (pad, bs), t_best = min(results.items(), key=lambda kv: kv[1])

    # stage 2: device-sweep knobs over the winning factorization policy
    facs = [multifrontal_cholesky(a, sym=sym, backend=backend, pad=pad,
                                  bs=bs, device=device)
            for a, sym in zip(mats, syms)]
    rhss = [np.random.default_rng(1).standard_normal((a.n, 4))
            for a in mats]
    sweep_results: Dict[Tuple[Optional[int], Optional[int]], float] = {}
    for sbs in sweep_bs_grid:
        for rt in rt_grid:
            sweep_results[(sbs, rt)] = sum(
                _best_warm(lambda f=f, B=B: multifrontal_solve(
                    f, B, mode="device", sweep_bs=sbs, rt=rt), repeats)
                for f, B in zip(facs, rhss))
            if on_candidate is not None:
                on_candidate("sweep", (sbs, rt), sweep_results[(sbs, rt)])
    (sweep_bs, rt), t_sweep = min(sweep_results.items(),
                                  key=lambda kv: kv[1])
    policy = SolvePolicy(bs=bs, pad=pad, device_kind=kind, backend=backend,
                         warm_factor_s=t_best, source="tuned",
                         sweep_bs=sweep_bs, rt=rt, warm_sweep_s=t_sweep)
    if out_dir:
        save_policy(policy, out_dir)
    return policy


def get_policy(dirpath: str = DEFAULT_AUTOTUNE_DIR, *,
               backend: str = "pipelined", autotune: bool = False,
               force: bool = False, device=None,
               **tune_kwargs) -> SolvePolicy:
    """The policy the engine should apply on ``device``: cached >
    (re)tuned > default.

    ``autotune=False`` never measures — it returns the persisted policy if
    one is valid for this device kind and backend, else the conservative
    default (``bs=None``, ``pad="pow2"``). ``autotune=True`` tunes on a
    cache miss; ``force=True`` ignores the cache and re-measures.
    """
    kind = device_kind(device)
    if not force:
        cached = load_policy(dirpath, kind, backend=backend)
        if cached is not None:
            return cached
    if autotune:
        return tune(backend=backend, out_dir=dirpath, device=device,
                    **tune_kwargs)
    return SolvePolicy(device_kind=kind, backend=backend, source="default")
