"""Serving over a mesh of cards against one card, on one machine.

    python3 scripts/mesh_serve_compare.py [--devices 4] [--arch qwen3-1.7b]
        [--prompt-len 4096] [--decode-steps 16] [--device cuda|cpu]
        [--smoke]

Three comparisons, one JSON line each:

* ``lm seq``: the layout of ``repro_torch.launch.serve --devices N
  --model-par 1`` at B 1, so the KV cache's sequence is split N ways over
  the data axis and decode runs ``sharded_decode_attention``;
* ``lm heads``: ``--model-par 2`` at B 1 (qwen3-1.7b's 8 kv heads tile the
  model axis; the sequence is split over the data axis);

  each against the same prefill and decode steps on one card, with the
  same seeded weights and prompt, every run fed the tokens the one-card
  run picks greedily (a greedy run of its own would follow its own picks
  after the first near tie): each step's logits as a share of the largest
  one-card logit, the picks, the near-tie gap where a pick differs,
  prefill seconds and the median decode ms a step of both; in bf16 and on
  a float32 copy of the weights (exit 1 unless the float32 picks are
  equal and the logits within ``chip_smoke.LM_MESH_TOL``, and every bf16
  pick that differs is a near tie); the runs are
  ``chip_smoke.decode_fed``, the checks its ``logit_shares`` and
  ``pick_differences``, as in ``chip_smoke.py``'s ``lm_serve_mesh``;
* ``selector``: a ``SolverEngine`` trained on the tracked label set, its
  featurizer and classifier over ``make_serving_mesh(N)`` against one
  card on the served selection batch (features bit-equal, names equal,
  warm ``select_batch`` seconds), then behind ``serve(rpc=True)`` with
  ``serving_devices`` N and 1 under ``chip_smoke.SERVING``'s traffic over
  ``chip_smoke.MESH_SUITE`` (requests/s, client p99, per-shard counters).

The card's name and power limit close the output. ``--device cpu
--smoke`` runs the same comparisons with gloo ranks, the smoke config and
N shards of the host. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def _lm_rank(rank: int, args, dp: int, mp: int, out_path: str) -> None:
    """One rank: the one-card run (every rank on its own card; rank 0's
    picks are the tokens every run is fed), then the mesh run, in bf16 and
    on a float32 copy of the weights, each after two warm-up steps."""
    import dataclasses

    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import make_batch, mesh_layout
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import tree_map

    dev = torch.device("cpu" if args.device == "cpu" else f"cuda:{rank}")
    mesh = make_mesh((dp, mp), ("data", "model"), dev)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    steps = args.decode_steps
    batch = make_batch(cfg, 1, args.prompt_len, dev)
    res = dict(mesh=f"{dp}x{mp}")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    for tag, c in (("bf16", cfg),
                   ("float32", dataclasses.replace(cfg, dtype="float32"))):
        if c is not cfg:
            params = tree_map(lambda t: t.float(), params)
        ctx, _, max_seq = mesh_layout(c, mesh, 1, args.prompt_len + steps)

        def run(n, on_mesh, feed=None):
            return cs.decode_fed(c, params, batch, n, max_seq,
                                 ctx if on_mesh else None, feed)

        run(2, False)                                 # warm the card
        one = run(steps, False)
        feed_t = torch.as_tensor(one["picks"], device=dev)
        dist.broadcast(feed_t, 0)                     # rank 0's picks
        feed = feed_t.cpu().numpy()
        run(2, True, feed)                            # warm the mesh
        got = run(steps, True, feed)
        rel = cs.logit_shares(got["logits"], one["logits"])
        res[tag] = dict(logits_rel_max=max(rel), logits_rel=rel,
                        picks_equal=bool(np.array_equal(got["picks"], feed)),
                        differing_picks=cs.pick_differences(
                            got["logits"], one["logits"], got["picks"],
                            feed),
                        prefill_s=got["prefill_s"],
                        prefill_s_one=one["prefill_s"],
                        decode_ms=got["step_s"] * 1e3,
                        decode_ms_one=one["step_s"] * 1e3)
        res["decode_seq_axes"] = ctx.decode_seq_axes
        res["cache_k_spec"] = ctx.cache_specs["layers"][0].get("k")
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)


def lm_case(args, name: str, mp: int) -> dict:
    from repro_torch.launch.mesh import run_ranks

    dp = args.devices // mp
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        run_ranks(_lm_rank, args.devices, tmp, args=(args, dp, mp, out),
                  device=args.device, timeout=1200)
        with open(out) as f:
            res = json.load(f)
    return dict(case=f"lm {name}", arch=args.arch, smoke=args.smoke,
                prompt=args.prompt_len, steps=args.decode_steps, **res)


def selector_case(args) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.core.features import (extract_features_batch_device,
                                           pad_csr_batch)
    from repro_torch.core.labeling import LabeledDataset
    from repro_torch.distributed import meshctx
    from repro_torch.engine import EngineConfig, SolverEngine
    from repro_torch.launch.rpc import PlanRPCClient
    from repro_torch.sparse.dataset import generate_suite

    dev = args.device
    engine = SolverEngine(EngineConfig(fast_grids=True, cv=3, device=dev))
    engine.train(LabeledDataset.load(os.path.join(ROOT, cs.LABELS)))
    sel = engine.selector
    served = list(generate_suite(16, seed=1, size_scale=2 if args.smoke
                                 else 8))
    batch = pad_csr_batch(served, bucket=True)
    meshes = {1: meshctx.make_serving_mesh(1, dev),
              args.devices: meshctx.make_serving_mesh(args.devices, dev)}
    feats, names, warm = {}, {}, {}
    for n, sm in meshes.items():
        feats[n] = extract_features_batch_device(batch, device=dev, mesh=sm)
        with meshctx.serving_mesh(sm):
            ts = []
            for _ in range(6):
                t0 = time.perf_counter()
                names[n], _ = sel.select_batch(served, path="device",
                                               device=dev)
                ts.append(time.perf_counter() - t0)
        warm[n] = sorted(ts[1:])
    res = dict(case="selector", shards=args.devices,
               features_equal=bool(torch.equal(
                   feats[1].cpu(), feats[args.devices].cpu())),
               names_equal=names[1] == names[args.devices],
               select_s_min={n: w[0] for n, w in warm.items()},
               select_s_median={n: w[len(w) // 2] for n, w in warm.items()})
    cfg_t = cs.SERVING
    mats = list(generate_suite(**cs.MESH_SUITE))
    rng = np.random.default_rng(cfg_t["seed"])
    pop = 1.0 / np.power(1.0 + np.arange(len(mats)), cfg_t["zipf_alpha"])
    stream = rng.choice(len(mats), size=cfg_t["requests"], p=pop / pop.sum())
    for n in meshes:
        eng = SolverEngine(EngineConfig(
            serving_devices=n, batch_size=cfg_t["batch"],
            max_wait_ms=cfg_t["max_wait_ms"], max_queue=cfg_t["max_queue"],
            build_workers=cfg_t["build_workers"], device=dev), selector=sel)
        srv, clients = None, []
        try:
            srv = eng.serve(rpc=True, host="127.0.0.1", port=0)
            clients = [PlanRPCClient("127.0.0.1", srv.port, timeout=300)
                       for _ in range(cfg_t["clients"])]
            results, wall = cs.drive_traffic(clients, mats, stream, cfg_t)
            snap = eng.metrics.snapshot()
        finally:
            for c in clients:
                c.close()
            if srv is not None:
                srv.close(timeout=60)
            meshctx.set_serving_mesh(None)
        cl = [r[4] for r in results]
        res[f"rpc_{n}"] = dict(
            ok=sum(r[0] == "ok" for r in results), requests=len(stream),
            requests_per_s=len(stream) / wall,
            client_ms_p50=cs._pct(cl, 50), client_ms_p99=cs._pct(cl, 99),
            shards={i: [snap.get(f"mesh.shard{i}.requests", 0),
                        snap.get(f"mesh.shard{i}.pad_rows", 0)]
                    for i in range(int(snap.get("mesh.shards", 0)))})
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=4)
    p.add_argument("--arch", default="qwen3-1.7b")
    p.add_argument("--prompt-len", type=int, default=4096)
    p.add_argument("--decode-steps", type=int, default=16)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--smoke", action="store_true")
    args = p.parse_args(argv)
    import torch

    if args.device == "cuda" and torch.cuda.device_count() < args.devices:
        print(f"mesh_serve_compare: {args.devices} cards wanted, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    import chip_smoke as cs

    ok = True
    for name, mp in (("seq", 1), ("heads", 2)):
        res = lm_case(args, name, mp)
        ok &= (res["float32"]["picks_equal"]
               and res["float32"]["logits_rel_max"] <= cs.LM_MESH_TOL
               and all(d["near_tie"]
                       for d in res["bf16"]["differing_picks"]))
        print(json.dumps(res), flush=True)
    res = selector_case(args)
    ok &= (res["features_equal"] and res["names_equal"]
           and all(res[f"rpc_{n}"]["ok"] == res[f"rpc_{n}"]["requests"]
                   for n in (1, args.devices)))
    print(json.dumps(res), flush=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
