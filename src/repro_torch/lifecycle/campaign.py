"""Port of ``repro/lifecycle/campaign.py``: sharded, resumable labeling
campaigns, the paper-scale data engine.

The paper's headline number needs argmin-solve-time labels over a large
matrix collection — a grid of (matrix × reordering algorithm) **cells**,
each one independent: reorder, symbolically analyze, factor + solve, time
it. :mod:`repro_torch.core.labeling` runs that grid as one in-process loop; this
module turns it into an operable campaign:

* **Sharding.** Cells fan out across a worker pool in-process (one task
  per matrix, the same pool shape as the dispatcher's build workers), and
  across *processes* via ``shard_index/shard_count`` (matrices are
  partitioned round-robin) — the CLI's ``--processes N`` launches N
  shard subprocesses, one per serving-mesh slot, and assembles their
  artifacts afterwards.
* **Resume-by-artifact.** Every matrix writes one JSON label artifact
  under ``artifacts/labels/<campaign_id>/`` recording its features and the
  measured cells so far (atomic tmp + replace). A killed run restarts by
  *reading* those artifacts and measuring only the missing cells —
  completed cells are never re-labeled, which also makes process shards
  coordination-free (disjoint matrices, disjoint files).
* **Reporting.** ``run_campaign`` returns a report dict (written as
  ``BENCH_campaign.json`` by the CLI): throughput, per-algorithm win
  counts, the label-time breakdown (ordering vs symbolic vs factor vs
  solve seconds), and the labeled/skipped cell split that the CI resume
  gate checks.
* **Assembly.** A complete campaign assembles into the exact
  :class:`repro_torch.core.labeling.LabeledDataset` layout, so
  ``train_selector`` / ``SolverEngine.train`` consume it unchanged.

    PYTHONPATH=src python -m repro_torch.lifecycle.campaign \\
        --campaign-id tiny --count 12 --scale 0.25 --workers 4 \\
        --out BENCH_campaign.json --dataset-out artifacts/labels_tiny.npz

Beyond the reference: :class:`CampaignConfig` (and the CLI's ``--device``)
names the device the label solves run on (``None`` is the card for the
device backends; the host ``numpy`` backend needs none), passed down to
:func:`repro_torch.sparse.multifrontal.factor_and_solve_timed`. A
``pipelined`` campaign with several workers runs that many factorizations
at once on one card, each with its own pinned buffers and stacks.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.labeling import LabeledDataset
from ..engine.registry import get_feature_set
from ..sparse.csr import CSRMatrix, permute_symmetric
from ..sparse.multifrontal import factor_and_solve_timed
from ..sparse.reorder import LABEL_ALGORITHMS, get_reordering

__all__ = ["CampaignConfig", "CampaignResult", "run_campaign",
           "assemble_dataset", "DEFAULT_LABELS_DIR"]

DEFAULT_LABELS_DIR = os.path.join("artifacts", "labels")

#: per-cell measurement fields persisted in the matrix artifact
_CELL_FIELDS = ("time", "t_order", "t_symbolic", "t_factor", "t_solve",
                "fill", "sym_flops")


@dataclasses.dataclass
class CampaignConfig:
    """One labeling campaign's identity and execution knobs."""

    campaign_id: str
    labels_dir: str = DEFAULT_LABELS_DIR
    algorithms: Sequence[str] = tuple(LABEL_ALGORITHMS)
    feature_set: str = "paper12"
    repeats: int = 1
    backend: str = "numpy"       # front-math substrate for the label solves
    workers: int = 4             # in-process worker pool (one task/matrix)
    shard_index: int = 0         # this process labels matrices with
    shard_count: int = 1         #   index % shard_count == shard_index
    max_cells: Optional[int] = None  # stop after N fresh cells (budget /
    #                                  kill-simulation; resume finishes it)
    device: Optional[str] = None  # where the label solves run (None: the
    #                               card for the device backends)

    def __post_init__(self) -> None:
        if not 0 <= self.shard_index < self.shard_count:
            raise ValueError(
                f"shard_index {self.shard_index} not in "
                f"[0, {self.shard_count})")
        if self.repeats < 1:
            raise ValueError("repeats must be >= 1")

    @property
    def directory(self) -> str:
        return os.path.join(self.labels_dir, self.campaign_id)


@dataclasses.dataclass
class CampaignResult:
    report: Dict[str, Any]
    #: assembled only when every matrix of the input suite is fully
    #: labeled (single shard, or after all shards ran) — None otherwise
    dataset: Optional[LabeledDataset]


# ---------------------------------------------------------------------------
# per-cell measurement + per-matrix artifact I/O
# ---------------------------------------------------------------------------

def _measure_cell(a: CSRMatrix, alg: str, repeats: int,
                  backend: str, device=None) -> Dict[str, Any]:
    """One grid cell: ordering time + best-of-``repeats`` factor+solve —
    the same protocol as :func:`repro_torch.core.labeling._measure_one`,
    with the backend (and its device) selectable so campaigns can label
    the device paths."""
    t0 = time.perf_counter()
    perm = get_reordering(alg)(a)
    t_order = time.perf_counter() - t0
    ap = permute_symmetric(a, perm)
    best: Optional[Dict[str, Any]] = None
    for _ in range(repeats):
        r = factor_and_solve_timed(ap, backend=backend, device=device)
        if best is None or r["time"] < best["time"]:
            best = r
    assert best is not None
    best["t_order"] = t_order
    return {k: (float(best[k]) if k.startswith("t") or k == "time"
                else int(best[k]))
            for k in _CELL_FIELDS}


def _safe_name(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]", "_", name) or "matrix"


def _artifact_path(cfg: CampaignConfig, name: str) -> str:
    return os.path.join(cfg.directory, f"{_safe_name(name)}.json")


def _load_artifact(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            rec = json.load(f)
        return rec if isinstance(rec.get("cells"), dict) else None
    except (OSError, json.JSONDecodeError):
        return None  # corrupt / partial write: relabel the matrix


def _write_artifact(path: str, rec: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(rec, f)
    os.replace(tmp, path)


def _fresh_record(a: CSRMatrix, cfg: CampaignConfig) -> Dict[str, Any]:
    fs = get_feature_set(cfg.feature_set)
    return dict(name=a.name, group=a.group, n=int(a.n), nnz=int(a.nnz),
                feature_set=cfg.feature_set,
                features=[float(v) for v in fs.extract(a)],
                repeats=cfg.repeats, backend=cfg.backend, cells={})


class _CellBudget:
    """Shared fresh-cell budget (``max_cells``): thread-safe take()."""

    def __init__(self, limit: Optional[int]):
        self._left = limit
        self._lock = threading.Lock()

    def take(self) -> bool:
        with self._lock:
            if self._left is None:
                return True
            if self._left <= 0:
                return False
            self._left -= 1
            return True


def _label_matrix(a: CSRMatrix, cfg: CampaignConfig, budget: _CellBudget
                  ) -> Tuple[int, int, bool]:
    """Label the missing cells of one matrix, resuming from its artifact.
    Returns (cells_labeled, cells_skipped, complete)."""
    path = _artifact_path(cfg, a.name)
    rec = _load_artifact(path)
    if rec is None or rec.get("feature_set") != cfg.feature_set:
        rec = _fresh_record(a, cfg)
    cells = rec["cells"]
    skipped = sum(1 for alg in cfg.algorithms if alg in cells)
    labeled = 0
    dirty = False
    for alg in cfg.algorithms:
        if alg in cells:
            continue
        if not budget.take():
            break
        cells[alg] = _measure_cell(a, alg, cfg.repeats, cfg.backend,
                                   cfg.device)
        labeled += 1
        dirty = True
        # persist after every cell: a kill between cells loses at most
        # the measurement in flight, and the artifact stays resumable
        _write_artifact(path, rec)
    if dirty and labeled == 0:  # pragma: no cover - defensive
        _write_artifact(path, rec)
    complete = all(alg in cells for alg in cfg.algorithms)
    return labeled, skipped, complete


# ---------------------------------------------------------------------------
# running a campaign
# ---------------------------------------------------------------------------

def _shard(mats: Sequence[CSRMatrix], cfg: CampaignConfig
           ) -> List[CSRMatrix]:
    return [a for i, a in enumerate(mats)
            if i % cfg.shard_count == cfg.shard_index]


def run_campaign(mats: Sequence[CSRMatrix], cfg: CampaignConfig, *,
                 metrics=None, verbose: bool = False) -> CampaignResult:
    """Label this shard's slice of the (matrix × algorithm) grid.

    Embarrassingly parallel: one worker task per matrix (matrix-level
    granularity keeps each artifact single-writer), ``cfg.workers`` tasks
    in flight — the numeric kernels release the GIL inside BLAS, and
    process-level sharding (``shard_index/shard_count``) covers the rest.
    Completed cells found on disk are skipped, never re-measured.
    """
    os.makedirs(cfg.directory, exist_ok=True)
    mine = _shard(mats, cfg)
    budget = _CellBudget(cfg.max_cells)
    t0 = time.perf_counter()
    results: List[Tuple[int, int, bool]] = []
    if cfg.workers <= 1 or len(mine) <= 1:
        for a in mine:
            results.append(_label_matrix(a, cfg, budget))
    else:
        with ThreadPoolExecutor(max_workers=cfg.workers,
                                thread_name_prefix="campaign") as pool:
            results = list(pool.map(
                lambda a: _label_matrix(a, cfg, budget), mine))
    wall = time.perf_counter() - t0

    labeled = sum(r[0] for r in results)
    skipped = sum(r[1] for r in results)
    complete_mats = sum(1 for r in results if r[2])
    if metrics is not None:
        metrics.counter("campaign.cells_labeled").inc(labeled)
        metrics.counter("campaign.cells_skipped").inc(skipped)
        metrics.counter("campaign.matrices").inc(len(mine))

    # aggregate the scorecard over *everything on disk for this shard*
    # (this run's fresh cells plus resumed ones — the campaign's state,
    # not this process invocation's)
    wins = {alg: 0 for alg in cfg.algorithms}
    breakdown = dict(order_s=0.0, symbolic_s=0.0, factor_s=0.0, solve_s=0.0)
    for a in mine:
        rec = _load_artifact(_artifact_path(cfg, a.name))
        if rec is None:
            continue
        cells = rec["cells"]
        for alg in cfg.algorithms:
            c = cells.get(alg)
            if c is None:
                continue
            breakdown["order_s"] += c["t_order"]
            breakdown["symbolic_s"] += c["t_symbolic"]
            breakdown["factor_s"] += c["t_factor"]
            breakdown["solve_s"] += c["t_solve"]
        done = {alg: cells[alg]["time"] for alg in cfg.algorithms
                if alg in cells}
        if len(done) == len(cfg.algorithms):
            wins[min(done, key=done.get)] += 1

    report = dict(
        campaign_id=cfg.campaign_id,
        shard=dict(index=cfg.shard_index, count=cfg.shard_count),
        workers=cfg.workers, backend=cfg.backend, repeats=cfg.repeats,
        algorithms=list(cfg.algorithms), feature_set=cfg.feature_set,
        matrices=len(mine), matrices_complete=complete_mats,
        cells_total=len(mine) * len(cfg.algorithms),
        cells_labeled=labeled, cells_skipped=skipped,
        cells_incomplete=(len(mine) * len(cfg.algorithms)
                          - labeled - skipped),
        wall_s=wall,
        cells_per_s=(labeled / wall) if wall > 0 and labeled else 0.0,
        per_algorithm_wins=wins, label_time_breakdown=breakdown,
        complete=(complete_mats == len(mine)))
    if verbose:
        print(f"[campaign {cfg.campaign_id}] shard "
              f"{cfg.shard_index}/{cfg.shard_count}: {labeled} cells "
              f"labeled, {skipped} resumed, "
              f"{report['cells_incomplete']} left "
              f"({wall:.2f} s, {report['cells_per_s']:.1f} cells/s)")

    dataset = None
    if cfg.shard_count == 1 and report["complete"]:
        dataset = assemble_dataset(mats, cfg)
    return CampaignResult(report=report, dataset=dataset)


def assemble_dataset(mats: Sequence[CSRMatrix],
                     cfg: CampaignConfig) -> LabeledDataset:
    """Fold the per-matrix artifacts back into a
    :class:`~repro_torch.core.labeling.LabeledDataset` (the exact layout
    ``train_selector`` consumes). Raises if any cell is missing — run the
    remaining shards (or resume) first."""
    fs = get_feature_set(cfg.feature_set)
    algs = list(cfg.algorithms)
    m, n_alg = len(mats), len(algs)
    feats = np.zeros((m, fs.dim))
    times = np.zeros((m, n_alg))
    order_times = np.zeros((m, n_alg))
    fills = np.zeros((m, n_alg), dtype=np.int64)
    flops = np.zeros((m, n_alg), dtype=np.int64)
    names, groups = [], []
    dims = np.zeros(m, dtype=np.int64)
    nnzs = np.zeros(m, dtype=np.int64)
    for i, a in enumerate(mats):
        rec = _load_artifact(_artifact_path(cfg, a.name))
        if rec is None:
            raise RuntimeError(
                f"campaign {cfg.campaign_id!r}: no label artifact for "
                f"matrix {a.name!r} — the campaign is incomplete")
        missing = [alg for alg in algs if alg not in rec["cells"]]
        if missing:
            raise RuntimeError(
                f"campaign {cfg.campaign_id!r}: matrix {a.name!r} is "
                f"missing cells for {missing} — resume the campaign first")
        feats[i] = np.asarray(rec["features"], dtype=float)
        names.append(rec["name"])
        groups.append(rec.get("group", ""))
        dims[i], nnzs[i] = rec["n"], rec["nnz"]
        for j, alg in enumerate(algs):
            c = rec["cells"][alg]
            times[i, j] = c["time"]
            order_times[i, j] = c["t_order"]
            fills[i, j] = c["fill"]
            flops[i, j] = c["sym_flops"]
    labels = times.argmin(axis=1)
    return LabeledDataset(feats, labels, times, order_times, fills, flops,
                          names, groups, dims, nnzs, algs,
                          feature_set=cfg.feature_set)


# ---------------------------------------------------------------------------
# CLI: shard fan-out + BENCH_campaign.json + resume gate
# ---------------------------------------------------------------------------

def _spawn_shards(argv_base: List[str], processes: int) -> None:
    """Run ``processes`` shard subprocesses (one serving-mesh slot each)
    and wait; any nonzero child fails the parent."""
    procs = []
    for i in range(processes):
        cmd = [sys.executable, "-m", "repro_torch.lifecycle.campaign",
               *argv_base, "--shard", f"{i}/{processes}"]
        procs.append(subprocess.Popen(cmd))
    codes = [p.wait() for p in procs]
    bad = [c for c in codes if c != 0]
    if bad:
        raise SystemExit(f"{len(bad)}/{processes} campaign shard "
                         f"processes failed (exit codes {codes})")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--campaign-id", default=None,
                   help="campaign identity (default derived from "
                        "count/seed/scale); artifacts land under "
                        "<labels-dir>/<campaign-id>/")
    p.add_argument("--labels-dir", default=DEFAULT_LABELS_DIR)
    p.add_argument("--count", type=int, default=12,
                   help="suite size "
                        "(repro_torch.sparse.dataset.generate_suite)")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--scale", type=float, default=0.25,
                   help="suite size_scale")
    p.add_argument("--repeats", type=int, default=1)
    p.add_argument("--backend", default="numpy",
                   choices=["numpy", "pallas", "batched", "pipelined"])
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="where the label solves run (default: the card "
                        "for the device backends)")
    p.add_argument("--feature-set", default="paper12")
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--shard", default="0/1", metavar="I/N",
                   help="label only matrices with index %% N == I")
    p.add_argument("--processes", type=int, default=0,
                   help="fan the campaign out over N shard subprocesses "
                        "(then assemble); 0 = this process only")
    p.add_argument("--max-cells", type=int, default=None,
                   help="stop after labeling N fresh cells (budgeted / "
                        "kill-simulation runs; a later run resumes)")
    p.add_argument("--out", default="BENCH_campaign.json",
                   help="campaign report path ('' to skip)")
    p.add_argument("--dataset-out", default=None,
                   help="write the assembled LabeledDataset .npz here "
                        "(requires a complete campaign)")
    p.add_argument("--gate-resume", action="store_true",
                   help="exit nonzero unless this run *resumed* work "
                        "(cells_skipped > 0 and the campaign completed) — "
                        "the CI resume-correctness gate")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        shard_index, shard_count = map(int, args.shard.split("/"))
    except ValueError:
        raise SystemExit(f"--shard must be I/N, got {args.shard!r}")
    campaign_id = (args.campaign_id
                   or f"c{args.count}_s{args.seed}_x{args.scale:g}")

    if args.processes > 0:
        base = ["--campaign-id", campaign_id,
                "--labels-dir", args.labels_dir,
                "--count", str(args.count), "--seed", str(args.seed),
                "--scale", str(args.scale), "--repeats", str(args.repeats),
                "--backend", args.backend,
                "--feature-set", args.feature_set,
                "--workers", str(args.workers), "--out", ""]
        if args.max_cells is not None:
            base += ["--max-cells", str(args.max_cells)]
        if args.device is not None:
            base += ["--device", args.device]
        _spawn_shards(base, args.processes)

    from ..sparse.dataset import generate_suite
    mats = list(generate_suite(count=args.count, seed=args.seed,
                               size_scale=args.scale))
    cfg = CampaignConfig(
        campaign_id=campaign_id, labels_dir=args.labels_dir,
        feature_set=args.feature_set, repeats=args.repeats,
        backend=args.backend, workers=args.workers, device=args.device,
        shard_index=shard_index, shard_count=shard_count,
        # after a subprocess fan-out this invocation only aggregates +
        # assembles: the children already spent the cell budget
        max_cells=(0 if args.processes > 0 else args.max_cells))
    res = run_campaign(mats, cfg, verbose=True)

    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(res.report, f, indent=2)
        print(f"[campaign {campaign_id}] report → {args.out}")
    if args.dataset_out:
        if res.dataset is None:
            ds = assemble_dataset(mats, cfg)  # raises if incomplete
        else:
            ds = res.dataset
        ds.save(args.dataset_out)
        print(f"[campaign {campaign_id}] dataset "
              f"({len(ds.names)} matrices) → {args.dataset_out}")
    if args.gate_resume:
        r = res.report
        ok = r["cells_skipped"] > 0 and r["complete"]
        print(f"[campaign {campaign_id}] resume gate: "
              f"skipped={r['cells_skipped']} labeled={r['cells_labeled']} "
              f"complete={r['complete']} → {'OK' if ok else 'FAIL'}")
        if not ok:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
