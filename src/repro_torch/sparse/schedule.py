"""Copy of ``repro/sparse/schedule.py``: ``build_schedule``, ``_pad_dim``,
``FrontPlan``, ``Bucket`` and ``LevelSchedule``.

Level scheduling of the supernodal assembly tree.

The multifrontal factorization is a postorder traversal of the assembly
tree, but the *only* true dependency is child → parent (a parent front
extend-adds its children's Schur complements). Grouping fronts by tree
**level** — ``level(k) = 1 + max(level(children))``, leaves at 0 — yields
batches of mutually independent fronts: two fronts at the same level can
never be ancestor/descendant, so every front of a level can be partially
factored in one batched device call. That turns the numeric phase from
``nsup`` host→device round trips into ``nlevels × nbuckets`` batched
kernel launches (:func:`repro_torch.kernels.ops.frontal_factor_batch_ws`).

Fronts within a level are **size-bucketed**: each front's pivot count and
update-row count are padded up (min ``MIN_PAD``) and fronts sharing a
padded shape form one batch. Pivot padding columns are decoupled identity
columns (they factor to 1 and contribute nothing); update-row padding is
zero rows. Bucketing bounds both the wasted FLOPs and the number of
distinct compiled kernel shapes — the trade-off between the two is the
**pad policy**:

* ``"pow2"`` (default) — next power of two: few compiled shapes, up to 4×
  padded FLOPs in the worst case.
* ``"mult8"`` — next multiple of 8: tighter occupancy (≤ ~2× waste on tiny
  fronts, far less on big ones) at the cost of more distinct shapes.

The right choice is device-dependent (compile cost vs wasted FLOPs), which
is why the reference's ``repro.autotune.solve_tuner`` measures it;
``occupancy`` / ``per_level_occupancy`` in :meth:`LevelSchedule.stats`
report the realized waste, per level so a bad pad choice on one wide level
is not averaged away.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from .symbolic import SymbolicFactor, supernodes

__all__ = ["FrontPlan", "Bucket", "LevelSchedule", "build_schedule",
           "front_flops", "PAD_POLICIES"]

MIN_PAD = 8

#: recognized bucket pad policies (the autotuned knob)
PAD_POLICIES = ("pow2", "mult8")


def _pad_dim(x: int, pad: str = "pow2") -> int:
    """Padded bucket dim ≥ x (0 stays 0; floor at MIN_PAD): next power of
    two under ``"pow2"``, next multiple of 8 under ``"mult8"``."""
    if x <= 0:
        return 0
    if pad == "mult8":
        return max(MIN_PAD, (int(x) + 7) // 8 * 8)
    if pad != "pow2":
        raise ValueError(f"unknown pad policy {pad!r} (want one of "
                         f"{PAD_POLICIES})")
    return max(MIN_PAD, 1 << (int(x) - 1).bit_length())


def front_flops(npiv: int, nrest: int) -> int:
    """Dense partial-factorization FLOPs of one front (chol + panel + Schur)."""
    return npiv * npiv * npiv // 3 + npiv * npiv * nrest + npiv * nrest * nrest


@dataclasses.dataclass
class FrontPlan:
    """Structure of one front, known before any numeric work."""

    k: int                   # supernode index (postorder position)
    c0: int                  # first pivot column
    c1: int                  # one past last pivot column
    rows: np.ndarray         # global row indices (sorted; first npiv = pivots)
    parent: int              # parent supernode, -1 for roots
    level: int               # assembly-tree level (leaves = 0)

    @property
    def npiv(self) -> int:
        return self.c1 - self.c0

    @property
    def m(self) -> int:
        return int(self.rows.shape[0])

    @property
    def nrest(self) -> int:
        return self.m - self.npiv

    @property
    def flops(self) -> int:
        return front_flops(self.npiv, self.nrest)


@dataclasses.dataclass
class Bucket:
    """Fronts of one level sharing a padded (pivot, rest) shape."""

    P: int                   # padded pivot dim (power of two ≥ MIN_PAD)
    R: int                   # padded update-row dim (power of two or 0)
    members: List[int]       # supernode indices

    @property
    def M(self) -> int:
        return self.P + self.R


@dataclasses.dataclass
class LevelSchedule:
    """Batched execution order for the numeric phase."""

    nsup: int
    fronts: List[FrontPlan]
    levels: List[np.ndarray]          # supernode ids per level, ascending
    buckets: List[List[Bucket]]       # per level, the size buckets
    pad: str = "pow2"                 # pad policy the buckets were built with

    @property
    def nlevels(self) -> int:
        return len(self.levels)

    def sweep_flops(self, k: int = 1) -> int:
        """FLOPs of one forward+backward triangular sweep over ``k`` RHS
        columns: per front, two npiv² triangular solves plus the L21 scatter
        and gather GEMVs (2·npiv·nrest each), per column."""
        return k * int(sum(2 * fp.npiv * fp.npiv + 4 * fp.npiv * fp.nrest
                           for fp in self.fronts))

    def stats(self) -> dict:
        widths = [len(lv) for lv in self.levels]
        # occupancy per level: true front cells / padded workspace cells of
        # that level's buckets — the global ratio hides a badly padded wide
        # level behind many well-packed small ones
        per_level: List[float] = []
        for li, lvl_buckets in enumerate(self.buckets):
            t = sum(self.fronts[int(k)].m ** 2 for k in self.levels[li])
            p = sum(b.M * b.M * len(b.members) for b in lvl_buckets)
            per_level.append(t / p if p else 1.0)
        true_cells = sum(fp.m * fp.m for fp in self.fronts)
        pad_cells = sum(b.M * b.M * len(b.members)
                        for lvl in self.buckets for b in lvl)
        nbatches = sum(len(lvl) for lvl in self.buckets)
        return dict(
            nsup=self.nsup,
            nlevels=self.nlevels,
            max_level_width=max(widths, default=0),
            mean_level_width=float(np.mean(widths)) if widths else 0.0,
            nbatches=nbatches,
            occupancy=true_cells / pad_cells if pad_cells else 1.0,
            per_level_occupancy=per_level,
            min_level_occupancy=min(per_level, default=1.0),
            pad=self.pad,
            front_flops=int(sum(fp.flops for fp in self.fronts)),
        )


def front_rows(sym: SymbolicFactor, c0: int, c1: int) -> np.ndarray:
    """Row structure of the front for pivot columns [c0, c1): the union of
    the columns' factor patterns, restricted to rows ≥ c0 (sorted, so the
    npiv pivot rows come first)."""
    Lp, Li = sym.Lp, sym.Li
    pats = [Li[Lp[j] : Lp[j + 1]] for j in range(c0, c1)]
    rows = np.unique(np.concatenate(pats))
    return rows[rows >= c0]


def build_schedule(sym: SymbolicFactor,
                   snode_ptr: np.ndarray | None = None,
                   snode_of: np.ndarray | None = None,
                   relax: int = 8, pad: str = "pow2") -> LevelSchedule:
    """Front structures + parent links + levels + size buckets.

    ``snode_ptr``/``snode_of`` may be passed to reuse an existing supernode
    partition; otherwise :func:`repro_torch.sparse.symbolic.supernodes` is called
    with ``relax``. ``pad`` picks the bucket pad policy (see module doc).
    """
    if snode_ptr is None or snode_of is None:
        snode_ptr, snode_of = supernodes(sym, relax=relax)
    nsup = int(snode_ptr.shape[0]) - 1
    fronts: List[FrontPlan] = []
    for k in range(nsup):
        c0, c1 = int(snode_ptr[k]), int(snode_ptr[k + 1])
        rows = front_rows(sym, c0, c1)
        npiv = c1 - c0
        # parent = supernode owning the first update row (None for roots)
        parent = int(snode_of[int(rows[npiv])]) if rows.shape[0] > npiv else -1
        fronts.append(FrontPlan(k, c0, c1, rows, parent, 0))

    # levels: children always precede parents in supernode order (a parent's
    # first column is past every child pivot), so one ascending pass works
    for fp in fronts:
        if fp.parent >= 0:
            pf = fronts[fp.parent]
            pf.level = max(pf.level, fp.level + 1)
    nlevels = max((fp.level for fp in fronts), default=-1) + 1
    levels = [np.array([fp.k for fp in fronts if fp.level == li],
                       dtype=np.int64) for li in range(nlevels)]

    # size buckets per level
    buckets: List[List[Bucket]] = []
    for lv in levels:
        by_shape: Dict[Tuple[int, int], List[int]] = {}
        for k in lv:
            fp = fronts[int(k)]
            key = (_pad_dim(fp.npiv, pad), _pad_dim(fp.nrest, pad))
            by_shape.setdefault(key, []).append(int(k))
        buckets.append([Bucket(P, R, members)
                        for (P, R), members in sorted(by_shape.items())])
    return LevelSchedule(nsup, fronts, levels, buckets, pad=pad)
