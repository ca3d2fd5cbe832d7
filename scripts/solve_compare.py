"""Time one source tree's solve kernels and solve set-up on the card, so
that two trees can be compared in one machine session.

Run from the root of the repository, on a machine with one CUDA device:

    python3 scripts/solve_compare.py [--src DIR]

``DIR`` (default: this checkout's ``src``) goes first on ``sys.path``, so
the port of an older commit unpacked under ``build/`` is timed by the same
code; its kernels build into that tree's own ``build/torch_kernels``. On
grid3d(32,32,32) under ``nd`` (the solve path of ``chip_smoke.py``) it runs
``execute_plan`` (pipelined, device sweeps, fp32 factors with fp64
refinement, one RHS) once to warm up and ``RUNS`` more times, keeping the
``factor.schedule``, ``factor.device``, ``solve.setup``, ``solve.sweep``
and ``solve.refine`` spans and the ``bell_spmv`` and ``extend_add_batch``
launches of each; profiles one more run and sums the device time of the
tri-solve, the ``bell_spmv``, the extend-add (stem ``extend_add``, both
designs) and the factor kernels by name (the factor's under the stems
``chip_smoke.FACTOR_STEMS``, which match both the first design's two
kernels and the current four, with their sum as ``device_s["factor"]``),
and counts its host-to-device copies and their seconds (``h2d``); times
the host build of the extend-add routing (``routing_build_s``:
``_route_contributions`` and, where the tree has it, ``_device_routing``,
``RUNS`` times each); times
the extend-add of the root and the populated fed bucket as that tree's
pipelined factor runs it (``chip_smoke.extend_add_as_path``: one launch a
bucket from the routing uploaded beforehand, or a launch and an upload per
source group) and ``row_stats`` on the served batch's arguments
(``csr_stats_args`` of ``generate_suite(16, seed=1, size_scale=8)``);
runs ``chip_smoke.frontal_check``
(the kernel held against its plain version, run twice with the same bits,
timed) on the populated and the largest bucket's assembled workspaces; runs
``chip_smoke.tri_solve_check`` (the kernel held against its plain version,
timed beside it and ``solve_triangular``) on the factored L11 of the
populated and the largest bucket, at one RHS and eight, both sweeps; and
times the tree's ``bell_spmv`` on the permuted matrix's fp64 blocks at
bs = 1 and 8, one RHS and eight (``chip_smoke.device_ms``). On the per-front
``pallas`` backend it factors the same matrix ``PF_RUNS`` times, keeping
``t_factor_dispatch``, ``t_factor_sync`` and the tile kernels' launches of
each; runs ``execute_plan`` with it once through the fp64 residual gate
(``chip_smoke.gate``); profiles one more run and sums the tile kernels'
device time by name; and runs ``chip_smoke.tile_checks`` on the peak front
(``chip_smoke.tile_fronts``), which holds each tile kernel against its
plain version and times ``matmul_nt`` at every (rows, N, K) of the
per-front path, ``tri_inv_tile`` at bs = 128, 100 and 33 and ``chol_tile``
at bs = 128, 100 and 33 and on an odd row stride. Prints one
JSON line; exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = 5
PF_RUNS = 3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the source tree whose repro_torch is timed")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("solve_compare: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.abspath(args.src)
    sys.path[:0] = [src, ROOT]
    import chip_smoke as cs
    from repro_torch.core.features import csr_stats_args, pad_csr_batch
    from repro_torch.core.plan import PlanBuilder, execute_plan
    from repro_torch.device import to_device
    from repro_torch.kernels import csr_stats, launch_counts, ops, spmv_bell
    from repro_torch.kernels._build import load_kernels
    from repro_torch.sparse import multifrontal as mf
    from repro_torch.sparse.csr import permute_symmetric
    from repro_torch.sparse.dataset import generate_suite, grid3d
    from repro_torch.sparse.multifrontal import (_route_contributions,
                                                 multifrontal_cholesky)

    load_kernels()
    dev = torch.device("cuda")
    a = grid3d(32, 32, 32, "grid3d_32")
    plan = PlanBuilder().build(a, "nd")
    b = np.random.default_rng(2).standard_normal(a.n)

    def solve():
        return execute_plan(a, plan, b, backend="pipelined", sweep="device",
                            solve_dtype="fp32_refine", device=dev)

    solve()
    runs = []
    for _ in range(RUNS):
        before = launch_counts()
        sp = solve()["spans"]
        after = launch_counts()
        runs.append({k: sp[k] for k in ("factor.schedule", "factor.device",
                                         "solve.setup", "solve.sweep",
                                         "solve.refine")})
        for k in ("bell_spmv", "extend_add_batch"):
            runs[-1][f"{k} launches"] = after[k] - before[k]
    spans = cs.profile_call("execute_plan", solve)
    device_s = {stem: cs.kernel_device_s(spans, stem)
                for stem in ("tri_solve", "bell_", "extend_add")
                + cs.FACTOR_STEMS}
    device_s["factor"] = sum(device_s[s]["total"] for s in cs.FACTOR_STEMS)
    h2d = cs.copy_events(spans, "HtoD")

    pa = permute_symmetric(a, plan.perm)
    f = multifrontal_cholesky(pa, sym=plan.sym, device=dev)
    routes = _route_contributions(f.schedule)
    # the host cost of the extend-add routing inside factor.schedule: the
    # routes of every tree, and the device routing of a tree that has one
    build_s = {}
    for name in ("_route_contributions", "_device_routing"):
        fn = getattr(mf, name, None)
        if fn is not None:
            build_s[name] = []
            for _ in range(RUNS):
                t0 = time.perf_counter()
                fn(f.schedule)
                build_s[name].append(time.perf_counter() - t0)
    picks = cs.pick_buckets(f.schedule, routes)
    extend_add = {}
    for tag in ("largest_fed", "populated_fed"):
        bk, w0, _ = cs.bucket_inputs(pa, f, routes, picks[tag], dev)
        run, wk = cs.extend_add_as_path(f, routes, picks[tag], dev), w0.clone()
        extend_add[f"{tag} B={len(bk.members)} M={bk.M}"] = cs.device_ms(
            lambda: run(wk), setup=lambda: wk.copy_(w0))
    ra = csr_stats_args(pad_csr_batch(list(generate_suite(
        16, seed=1, size_scale=8)), bucket=True), dev)[1]
    row_stats_ms = cs.device_ms(lambda: csr_stats.row_stats(*ra))
    frontal = {}
    for tag in ("populated", "largest"):
        bk, w0, groups = cs.bucket_inputs(pa, f, routes, picks[tag], dev)
        for u, off, srcs, dst, rows in groups:
            ops.extend_add_batch(w0, u, dst, rows, src=srcs, off=off)
        frontal[f"{tag} B={len(bk.members)} P={bk.P} M={bk.M}"] = \
            cs.frontal_check({}, tag, w0, bk.P, ops.pick_block_size(bk.P),
                             False)
    rng = np.random.default_rng(1)
    tri = {}
    for tag in ("populated", "largest"):
        li, bj = picks[tag]
        B, P = len(f.schedule.buckets[li][bj].members), \
            f.schedule.buckets[li][bj].P
        L = f.device_stacks[(li, bj)][:, :P, :P]
        bs = ops.pick_block_size(P)
        for k in (1, 8):
            x0 = torch.as_tensor(rng.standard_normal((B, P, k)),
                                 dtype=torch.float32, device=dev)
            for lower in (True, False):
                shape = f"{tag} B={B} P={P}"
                tri[f"{shape} k={k} {'lower' if lower else 'upper'}"] = \
                    cs.tri_solve_check({}, shape, L, x0, bs, k, lower, False)
    bell = {}
    for bs in (1, 8):
        blocks, idx, npad = spmv_bell.csr_to_bell(pa.indptr, pa.indices,
                                                  pa.data, pa.n, bs)
        blocks_d, idx_d = to_device(blocks, dev), to_device(idx, dev)
        for k in (1, 8):
            x = torch.as_tensor(rng.standard_normal((npad, k)), device=dev)
            bell[f"bs={bs} k={k}"] = cs.device_ms(
                lambda: spmv_bell.bell_spmv(blocks_d, idx_d, x))

    # the per-front (pallas) backend: its factor's host split and launches,
    # the gated solve, the tile kernels' device time and kernel ms
    per_front = []
    for _ in range(PF_RUNS):
        before = launch_counts()
        st = multifrontal_cholesky(pa, sym=plan.sym, backend="pallas",
                                   device=dev).stats
        after = launch_counts()
        per_front.append({k: st[k] for k in ("t_factor_dispatch",
                                             "t_factor_sync")})
        per_front[-1]["launches"] = {k: after[k] - before[k]
                                     for k in cs.TILE_KERNELS}
    cs.gate("per_front execute_plan pallas", a,
            execute_plan(a, plan, b, backend="pallas", sweep="device",
                         solve_dtype="fp32_refine", device=dev), b)
    spans = cs.profile_call("execute_plan pallas", lambda: execute_plan(
        a, plan, b, backend="pallas", device=dev))
    device_s["tile"] = {stem: cs.kernel_device_s(spans, stem)
                        for stem in cs.TILE_STEMS}
    bk, w, k = cs.tile_fronts(pa, f, routes, dev)["peak"]
    tile_ms = cs.tile_checks("peak", f.schedule, bk, w, k, {},
                             cs.per_front_products(f.schedule))
    print(json.dumps({"src": os.path.relpath(src, ROOT),
                      "device": torch.cuda.get_device_name(0),
                      "runs": runs, "routing_build_s": build_s,
                      "device_s": device_s, "h2d": h2d,
                      "extend_add_ms": extend_add,
                      "row_stats_ms": row_stats_ms,
                      "frontal_factor_batch": frontal,
                      "tri_solve": tri, "bell_spmv_ms": bell,
                      "per_front": per_front, "tile_ms": tile_ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
