#!/usr/bin/env python
"""engine status of the PyTorch port: render a port bundle's report card, a
port registry's lineage, and/or a live port server's stats; the
counterpart of ``scripts/engine_status.py``, which reads the JAX
package's.

    PYTHONPATH=src python scripts/engine_status_torch.py --bundle sel.bundle
    PYTHONPATH=src python scripts/engine_status_torch.py --port 7077
    PYTHONPATH=src python scripts/engine_status_torch.py \
        --registry artifacts/bundles_torch

Three independent views, composable in one invocation:

* ``--bundle PATH`` — load a :class:`SelectorBundle` (validating it) and
  render its schema-v2 report card: fingerprint, model/scaler/feature-set
  names, held-out accuracy, per-algorithm recall, the confusion matrix,
  and the dataset provenance.
* ``--registry DIR`` — render a :class:`repro_torch.lifecycle.registry
  .BundleRegistry`: every registered version with its status, accuracy,
  and the lineage chain of the serving bundle (which retrains produced
  production).
* ``--host/--port`` — connect a :class:`PlanRPCClient` to a running port
  plan server (``repro_torch.launch.rpc``) and print its live ``stats()`` (requests, hit rates, shed /
  rejected counts, queue depth, latency percentiles) plus the structured
  metrics snapshot (``--metrics`` for every instrument), including the
  shadow-evaluation scorecard and the serving mesh's per-shard
  utilization (``mesh.shards``, ``mesh.shard<i>.requests`` /
  ``.pad_rows``) when those subsystems are active.

Imports the port (``repro_torch``: torch and numpy) and the standard
library only, nothing of JAX; exits nonzero if a requested view cannot be
produced.
"""
from __future__ import annotations

import argparse
import sys


def _fmt_pct(x) -> str:
    return "—" if x is None else f"{100.0 * float(x):5.1f}%"


def render_bundle(path: str) -> int:
    from repro_torch.engine.bundle import BundleValidationError, SelectorBundle

    try:
        b = SelectorBundle.load(path)
    except (OSError, BundleValidationError) as exc:
        print(f"[engine-status] cannot load bundle {path!r}: {exc}")
        return 1
    print(f"bundle      {path}")
    print(f"schema      v{b.schema_version}")
    print(f"fingerprint {b.fingerprint}")
    print(f"model       {b.model_name}   scaler {b.scaler_name}")
    print(f"features    {b.feature_set} ({len(list(b.feature_names))} dims)")
    print(f"algorithms  {', '.join(b.algorithms)}")
    rc = b.report_card
    if not rc:
        print("report card —  (schema v1 bundle, or saved without training)")
        return 0
    print(f"report card")
    print(f"  test accuracy  {_fmt_pct(rc.get('test_accuracy'))}"
          + (f"   cv score {_fmt_pct(rc.get('cv_score'))}"
             if rc.get("cv_score") is not None else ""))
    recall = rc.get("per_algorithm_recall") or {}
    support = rc.get("test_support") or {}
    for alg in b.algorithms:
        if alg in recall:
            sup = support.get(alg)
            print(f"  recall {alg:<12} {_fmt_pct(recall[alg])}"
                  + (f"   (n={sup})" if sup is not None else ""))
    conf = rc.get("confusion")
    if conf:
        width = max(len(a) for a in b.algorithms)
        head = " ".join(f"{a[:6]:>6}" for a in b.algorithms)
        print(f"  confusion (rows=true)  {'':<{width}} {head}")
        for alg, row in zip(b.algorithms, conf):
            cells = " ".join(f"{int(c):>6}" for c in row)
            print(f"  {'':<21}  {alg:<{width}} {cells}")
    prov = b.provenance
    if prov:
        print(f"provenance  {prov.get('n_samples')} samples, "
              f"feature set {prov.get('feature_set')}, "
              f"dims {prov.get('dim_range')}, nnz {prov.get('nnz_range')}")
        counts = prov.get("label_counts") or {}
        if counts:
            print("  labels      "
                  + ", ".join(f"{k}: {v}" for k, v in counts.items()))
    return 0


def render_registry(root: str) -> int:
    from repro_torch.lifecycle.registry import BundleRegistry, BundleRegistryError

    try:
        reg = BundleRegistry(root)
        entries = reg.entries()
        serving = reg.serving_version()
        previous = reg.previous_version()
    except (OSError, BundleRegistryError) as exc:
        print(f"[engine-status] cannot read registry {root!r}: {exc}")
        return 1
    if not entries:
        print(f"registry    {root}  (empty)")
        return 0
    print(f"registry    {root}  ({len(entries)} bundles)")
    for e in entries:
        mark = ("▶" if e["version"] == serving
                else "↩" if e["version"] == previous else " ")
        acc = e.get("test_accuracy")
        print(f"  {mark} {e['version']}  {e['status']:<11} "
              f"model={e.get('model')}  acc={_fmt_pct(acc).strip()}"
              + (f"  source={e['source']}" if e.get("source") else ""))
    chain = reg.lineage()
    if chain:
        arrows = " → ".join(e["version"] for e in reversed(chain))
        print(f"lineage     {arrows}  (oldest → serving)")
    if previous:
        print(f"rollback    would restore {previous}")
    return 0


def _render_shadow_panel(m: dict) -> None:
    """The shadow.* scorecard, when a candidate is (or was) riding."""
    if not m.get("shadow.requests"):
        return
    n = m.get("shadow.evaluated", 0)
    print(f"shadow      {int(m['shadow.requests'])} mirrored, "
          f"{int(n)} evaluated "
          f"({int(m.get('shadow.agreements', 0))} agree / "
          f"{int(m.get('shadow.disagreements', 0))} disagree), "
          f"{int(m.get('shadow.dropped', 0))} dropped")
    if n:
        print(f"  agreement rate {_fmt_pct(m.get('shadow.agreement_rate'))}"
              f"   win rate {_fmt_pct(m.get('shadow.win_rate'))}"
              f"   (counterfactual predicted flops)")


def _render_refine_histogram(m: dict) -> None:
    """Refinement-iteration distribution from the solve.refine_iters.<i>
    counters (the last bucket, 8, collects everything beyond it)."""
    counts = {}
    for k, v in m.items():
        if k.startswith("solve.refine_iters."):
            counts[int(k.rsplit(".", 1)[-1])] = int(v)
    if not counts:
        return
    total = sum(counts.values())
    peak = max(counts.values())
    print(f"  refine iterations ({total} refined solves, "
          f"mean {m.get('solve.refine_iterations.mean', 0.0):.1f})")
    for i in sorted(counts):
        bar = "█" * max(1, round(counts[i] / peak * 24))
        label = f"{i}+" if i >= 8 else f"{i} "
        print(f"    {label} {bar} {counts[i]}")


def _render_mesh_panel(m: dict) -> None:
    """Per-shard serving-mesh utilization from the mesh.* instruments."""
    nd = int(m.get("mesh.shards", 0) or 0)
    if nd <= 0:
        return
    rows = []
    for i in range(nd):
        req = m.get(f"mesh.shard{i}.requests")
        pad = m.get(f"mesh.shard{i}.pad_rows")
        if req is None:
            break
        rows.append((i, int(req), int(pad or 0)))
    if not rows:
        return
    print(f"mesh        {nd} shard(s), per-shard rows (real/pad):")
    for i, req, pad in rows:
        total = req + pad
        waste = (pad / total) if total else 0.0
        print(f"  shard {i:<3} {req:>8} real  {pad:>8} pad  "
              f"({waste * 100:4.1f}% waste)")


def render_server(host: str, port: int, show_all_metrics: bool) -> int:
    from repro_torch.launch.rpc import PlanRPCClient

    try:
        client = PlanRPCClient(host, port, timeout=30, connect_retries=1)
    except ConnectionError as exc:
        print(f"[engine-status] cannot reach {host}:{port}: {exc}")
        return 1
    with client as c:
        pong = c.ping()
        s = c.stats()
        try:
            m = c.metrics()
        except Exception:  # pre-metrics server
            m = {}
    print(f"server      {host}:{port}  up {pong.get('uptime_s', 0.0):.0f} s")
    print(f"fingerprint-versioned cache: "
          f"{s.get('size', 0)}/{s.get('capacity', 0)} in memory"
          + (f", {s.get('disk_entries')} on disk"
             if s.get("disk_entries") is not None else ""))
    total = s.get("requests", 0)
    print(f"traffic     {total} requests: {s.get('warm_hits', 0)} warm, "
          f"{s.get('shed', 0)} shed, {s.get('rejected', 0)} rejected, "
          f"{s.get('errors', 0)} errors")
    print(f"cache       hit rate {s.get('hit_rate', 0.0):.2f} "
          f"({s.get('hits', 0)} hits / {s.get('misses', 0)} misses"
          + (f", {s.get('disk_hits')} disk" if "disk_hits" in s else "")
          + ")")
    if "p50_ms" in s:
        print(f"latency     p50 {s['p50_ms']:.2f} ms   "
              f"p99 {s['p99_ms']:.2f} ms   mean {s['mean_ms']:.2f} ms")
    for stage in ("queue", "select", "build"):
        k = f"stage_{stage}_p50_ms"
        if k in s:
            print(f"  stage {stage:<7} p50 {s[k]:8.2f} ms   "
                  f"p99 {s[f'stage_{stage}_p99_ms']:8.2f} ms")
    # numeric solve-stage breakdown (repro_torch.core.plan.execute_plan
    # mirrors its RequestContext spans into stage.* histograms): host
    # assembly vs device-blocked time vs triangular sweeps
    solve_stages = [st for st in ("permute", "factor", "factor.assemble",
                                  "factor.device", "solve.sweep",
                                  "solve.refine")
                    if f"stage.{st}.p50" in m]
    if solve_stages:
        print("solve stages")
        for st in solve_stages:
            print(f"  {st:<16} p50 {m[f'stage.{st}.p50'] * 1e3:8.2f} ms   "
                  f"p99 {m[f'stage.{st}.p99'] * 1e3:8.2f} ms   "
                  f"n={int(m.get(f'stage.{st}.count', 0))}")
        ov = m.get("solve.overlap_efficiency")
        if ov is not None:
            print(f"  overlap efficiency {ov:.2f} "
                  f"(host-busy fraction of assembly + device wait)")
        # which triangular-sweep substrate served the solves
        modes = {k.rsplit(".", 1)[-1]: int(m[k]) for k in m
                 if k.startswith("solve.sweep.") and k.count(".") == 2}
        if modes:
            print("  sweep backends  "
                  + "  ".join(f"{mode}={cnt}"
                              for mode, cnt in sorted(modes.items())))
        _render_refine_histogram(m)
    _render_shadow_panel(m)
    _render_mesh_panel(m)
    print(f"queue       depth {s.get('queue_depth', 0)}"
          + (f" / max_queue {s.get('max_queue')}"
             if s.get("max_queue") else " (unbounded)")
          + f", {s.get('inflight_keys', 0)} builds in flight")
    print(f"cold stages {s.get('select_calls', 0)} select calls "
          f"({s.get('select_seconds', 0.0) * 1e3:.0f} ms), "
          f"{s.get('plans_built', 0)} plans built "
          f"({s.get('build_seconds', 0.0) * 1e3:.0f} ms)")
    if m and show_all_metrics:
        print("metrics")
        for k in sorted(m):
            v = m[k]
            print(f"  {k:<32} "
                  + (f"{v:.4f}" if isinstance(v, float) else str(v)))
    elif m:
        interesting = [k for k in sorted(m)
                       if not k.rsplit(".", 1)[-1] in ("sum", "mean")]
        shown = ", ".join(f"{k.split('.', 1)[-1]}={m[k]:.0f}"
                          for k in interesting
                          if isinstance(m[k], (int, float))
                          and k.startswith(("rpc.", "dispatch."))
                          and not k.endswith(("_s.p50", "_s.p99",
                                              "_s.count")))
        if shown:
            print(f"metrics     {shown}  (--metrics for all)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Render a SelectorBundle report card and/or a live "
                    "plan server's stats + metrics.")
    p.add_argument("--bundle", default=None,
                   help="path to a SelectorBundle to render")
    p.add_argument("--registry", default=None, metavar="DIR",
                   help="bundle registry directory to render "
                        "(versions, statuses, serving lineage)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=None,
                   help="RPC port of a running plan server")
    p.add_argument("--metrics", action="store_true",
                   help="print the full metrics snapshot")
    args = p.parse_args(argv)
    if args.bundle is None and args.port is None and args.registry is None:
        p.error("nothing to do: pass --bundle, --registry, and/or --port")
    rc = 0
    shown = False
    if args.bundle:
        rc |= render_bundle(args.bundle)
        shown = True
    if args.registry:
        if shown:
            print()
        rc |= render_registry(args.registry)
        shown = True
    if args.port is not None:
        if shown:
            print()
        rc |= render_server(args.host, args.port, args.metrics)
    return rc


if __name__ == "__main__":
    sys.exit(main())
