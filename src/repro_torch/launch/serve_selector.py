"""Port of ``repro/launch/serve_selector.py``: reorder-selection serving,
the async plan pipeline and the synchronous name-only front-end.

    PYTHONPATH=src python -m repro_torch.launch.serve_selector \
        --requests 256 --batch 16            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve_selector \
        --requests 48 --distinct 12 --device cpu --cache-dir ''

A stream of matrices with repeated structures (Zipf-like popularity) hits
an :class:`AsyncPlanServer` built by ``SolverEngine.serve()``. Warm
structures are answered at submit time from the plan cache; misses go
through the deadline micro-batcher, where the batcher thread featurizes
each micro-batch on the card (``entry_stats`` / ``row_stats``) and
classifies it there, and a pool of build workers runs reorder + symbolic
analysis and installs each plan. With a disk tier (``--cache-dir``, default
:data:`repro_torch.core.plan_cache.DEFAULT_CACHE_DIR`), a restarted server
starts warm.

:class:`SelectorServer` is the synchronous front-end for callers that only
want the algorithm name.
"""
from __future__ import annotations

import argparse
import collections
import time
from typing import Dict, List, Optional, Sequence

from ..core.dispatch import PlanDispatcher
from ..core.plan_cache import PlanCache, matrix_fingerprint
from ..sparse.csr import CSRMatrix

__all__ = ["SelectorServer", "AsyncPlanServer", "main"]


class SelectorServer:
    """Batched, cached front-end around a trained ``ReorderSelector``.

    ``handle(mats)`` answers a request batch: fingerprint every matrix,
    serve repeats from the LRU cache, group the misses into batches of
    ``batch_size`` (padded on the device path) for the selector, and cache
    the fresh names. Duplicate structures within one request batch are
    featurized once. ``device`` is where the device path runs (``None`` →
    CUDA).
    """

    def __init__(self, selector, *, batch_size: int = 16,
                 cache_capacity: int = 4096, path: str = "device",
                 device=None):
        self.selector = selector
        self.batch_size = batch_size
        self.cache = PlanCache(cache_capacity)
        self.path = path
        self.device = device
        self.select_seconds = 0.0
        self.requests = 0

    def handle(self, mats: Sequence[CSRMatrix]) -> List[str]:
        self.requests += len(mats)
        keys = [matrix_fingerprint(m) for m in mats]
        names: List[Optional[str]] = [None] * len(mats)
        miss_idx: List[int] = []
        pending: Dict[str, List[int]] = {}
        for i, key in enumerate(keys):
            hit = self.cache.get(key)
            if hit is not None:
                names[i] = hit
            elif key in pending:
                pending[key].append(i)  # intra-batch duplicate: one featurize
            else:
                pending[key] = [i]
                miss_idx.append(i)
        # size-tiered batching: chunks of a size-sorted miss list keep each
        # padded batch near its members' true sizes
        miss_idx.sort(key=lambda i: (mats[i].nnz, mats[i].n))
        for lo in range(0, len(miss_idx), self.batch_size):
            chunk = miss_idx[lo : lo + self.batch_size]
            batch = [mats[i] for i in chunk]
            if self.path == "device":
                # one batch size on the device path; filler results dropped
                batch += [batch[0]] * (self.batch_size - len(chunk))
            got, dt = self.selector.select_batch(batch, path=self.path,
                                                 device=self.device)
            self.select_seconds += dt
            for i, name in zip(chunk, got):
                self.cache.put(keys[i], name)
                for j in pending[keys[i]]:
                    names[j] = name
        return names  # type: ignore[return-value]

    def stats(self) -> dict:
        s = self.cache.stats()
        s.update(requests=self.requests, select_seconds=self.select_seconds)
        return s


class AsyncPlanServer(PlanDispatcher):
    """In-process async plan server: :class:`repro_torch.core.dispatch
    .PlanDispatcher` under its serving name, with requests submitted by
    method call. The RPC front-end (:class:`repro_torch.launch.rpc
    .PlanRPCServer`) wraps the same class for out-of-process clients."""


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--requests", type=int, default=256)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--cache", type=int, default=512)
    p.add_argument("--cache-dir", default=None,
                   help="persistent plan-cache dir (default "
                        "artifacts/plan_cache_torch; pass '' to stay "
                        "in-memory)")
    p.add_argument("--max-disk-mb", type=float, default=None,
                   help="disk-tier byte budget (LRU-by-mtime eviction)")
    p.add_argument("--max-disk-entries", type=int, default=None,
                   help="disk-tier file-count cap")
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--build-workers", type=int, default=2)
    p.add_argument("--path", choices=["host", "device"], default="device")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where the device path and training run (default: "
                        "the card)")
    p.add_argument("--model", default="random_forest")
    p.add_argument("--distinct", type=int, default=48,
                   help="distinct structures in the request stream")
    p.add_argument("--campaign-count", type=int, default=36)
    p.add_argument("--campaign-scale", type=float, default=0.35)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)

    import numpy as np

    from ..core.labeling import load_or_build
    from ..core.plan_cache import DEFAULT_CACHE_DIR
    from ..engine import EngineConfig, SolverEngine
    from ..sparse.dataset import generate_suite

    # the engine versions the plan cache with the fitted model's
    # fingerprint, so a retrained selector never serves its predecessor's
    # persisted plans
    cache_dir = (args.cache_dir if args.cache_dir is not None
                 else DEFAULT_CACHE_DIR)
    engine = SolverEngine(EngineConfig(
        model=args.model, cache_dir=cache_dir or None,
        cache_capacity=args.cache,
        cache_max_disk_bytes=(int(args.max_disk_mb * 2**20)
                              if args.max_disk_mb else None),
        cache_max_disk_entries=args.max_disk_entries,
        path=args.path, batch_size=args.batch, device=args.device,
        max_wait_ms=args.max_wait_ms, build_workers=args.build_workers,
        fast_grids=True, cv=3, seed=0))
    ds = load_or_build(cache_dir="artifacts", count=args.campaign_count,
                       seed=args.seed, size_scale=args.campaign_scale,
                       repeats=1, verbose=True)
    rep = engine.train(ds)
    print(f"[serve-selector] model={args.model} "
          f"test_acc={rep['test_accuracy']:.2f} "
          f"fingerprint={engine.fingerprint[:16]}")

    pool = list(generate_suite(count=args.distinct, seed=args.seed + 1,
                               size_scale=0.4))
    rng = np.random.default_rng(args.seed)
    # zipf-ish popularity: a few hot structures dominate
    pop = 1.0 / (1.0 + np.arange(len(pool)))
    pop /= pop.sum()
    stream = rng.choice(len(pool), size=args.requests, p=pop)

    server = engine.serve()
    try:
        # first use builds the kernels: keep it out of the timed region,
        # then zero the metrics (with a warm disk tier this is a disk hit)
        server.handle([pool[0]])
        server.reset_stats()
        t0 = time.perf_counter()
        futs = [server.submit(pool[i]) for i in stream]
        plans = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
    finally:
        server.close()

    s = server.stats()
    print(f"[serve-selector] path={args.path} device="
          f"{args.device or 'cuda'} batch={args.batch} "
          f"wait={args.max_wait_ms}ms workers={args.build_workers} "
          f"disk={'off' if not cache_dir else cache_dir}")
    print(f"[serve-selector] {args.requests} requests in {wall*1e3:.0f} ms "
          f"→ {args.requests / wall:.0f} plans/sec end-to-end")
    print(f"[serve-selector] cache: {s['hits']} hits / {s['misses']} misses "
          f"(hit rate {s['hit_rate']:.2f}), {s['evictions']} evictions, "
          f"size {s['size']}/{s['capacity']}"
          + (f", disk {s['disk_hits']} hits / {s['disk_entries']} entries"
             if "disk_hits" in s else ""))
    print(f"[serve-selector] latency: p50 {s.get('p50_ms', 0.0):.2f} ms, "
          f"p99 {s.get('p99_ms', 0.0):.2f} ms "
          f"({s['warm_hits']} warm submits)")
    print(f"[serve-selector] cold stages: select {s['select_calls']} calls "
          f"{s['select_seconds']*1e3:.0f} ms, "
          f"{s['plans_built']} plans built {s['build_seconds']*1e3:.0f} ms")
    if s.get("max_disk_bytes") or s.get("max_disk_entries"):
        print(f"[serve-selector] disk budget: {s['disk_bytes']} bytes / "
              f"{s['disk_entries']} files, {s['disk_evictions']} evictions")
    dist = collections.Counter(pl.algorithm for pl in plans)
    print(f"[serve-selector] plan distribution: {dict(sorted(dist.items()))}")


if __name__ == "__main__":
    main()
