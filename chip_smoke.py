"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of the repository, on a machine with one CUDA device:

    python3 chip_smoke.py

It builds the four CUDA kernels from ``src/repro_torch/kernels/csrc``,
drives the main path (``PlanBuilder.build`` → ``execute_plan`` with
``backend="pipelined"``, ``sweep="device"``, ``solve_dtype="fp32_refine"``)
on ``grid3d(20,20,20)`` under ``amd``, ``scotch``, ``nd`` and ``rcm`` and on
``grid3d(32,32,32)`` under ``nd`` (n = 32,768), each for one RHS and for
eight, and requires a relative residual ≤ 1e-10 (fp64, scipy) and converged
refinement. The launch counts of the four kernel wrappers are zeroed just
before that run and read just after it; each must be positive. Then it
holds each kernel against its plain PyTorch version at shapes taken from the
32³ schedule (its most populated and its largest bucket) and times kernel,
plain version and, where one exists, the PyTorch library call computing the
same function. It prints the stage times, a ``kernels`` JSON line, the
card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without a CUDA
device. Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: NVIDIA H100 SXM peaks (data sheet): fp32 on the CUDA cores, fp64 on the
#: CUDA cores, device-memory bandwidth
PEAK_FP32 = 67e12
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12

#: relative tolerances of kernel vs plain version (max abs error over the
#: largest magnitude of the plain result). f32: the two sum in different
#: orders; the factor's error grows with the front (M up to 1,280 here, and
#: each Schur entry is a sum of up to P = 256 products), hence 1e-4. fp64
#: SpMV: both sum the same products of one block-row, in other orders.
TOL = {"frontal_factor_batch": 1e-4, "extend_add_batch": 1e-5,
       "tri_solve_batch": 1e-5, "bell_spmv": 1e-12}

REPLACES = {
    "frontal_factor_batch": "src/repro/kernels/frontal_cholesky.py:391",
    "extend_add_batch": "src/repro/kernels/frontal_cholesky.py:280",
    "tri_solve_batch": "src/repro/kernels/frontal_cholesky.py:364",
    "bell_spmv": "src/repro/kernels/spmv_bell.py:91",
}
SOURCE = {
    "frontal_factor_batch": "src/repro_torch/kernels/csrc/frontal_factor.cu",
    "extend_add_batch": "src/repro_torch/kernels/csrc/extend_add.cu",
    "tri_solve_batch": "src/repro_torch/kernels/csrc/tri_solve.cu",
    "bell_spmv": "src/repro_torch/kernels/csrc/spmv_bell.cu",
}


def log(*args) -> None:
    print(*args, flush=True)


def rel_residual(a, x: np.ndarray, b: np.ndarray) -> float:
    import scipy.sparse as sp

    A = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
    return float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))


# -- timing --------------------------------------------------------------------

def device_ms(fn, setup=None, reps: int = 10) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around each call, with
    a sleep kernel queued first so that the card is still busy while the
    host enqueues the call (the events then bracket device work only).
    ``setup`` (restoring an in-place input) runs before the sleep."""
    import torch

    for _ in range(2):
        if setup:
            setup()
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in ev:
        if setup:
            setup()
        torch.cuda._sleep(2_000_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / reps


def stream_ms(fn, setup=None, reps: int = 3) -> float:
    """Mean time of ``fn`` on the stream in ms, launch gaps included (the
    plain versions are chains of many small PyTorch ops)."""
    import torch

    if setup:
        setup()
    fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for s, e in ev:
        if setup:
            setup()
        torch.cuda.synchronize()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in ev) / reps


def bound(flops: float, nbytes: float, peak_flops: float) -> tuple:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(name: str, got, want) -> float:
    """Max abs error of ``got`` against ``want``; raises beyond TOL. Syncs
    first, so a fault in the kernel surfaces here."""
    import torch

    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    if not (np.isfinite(err) and err <= TOL[name] * max(scale, 1e-30)):
        raise AssertionError(f"{name}: max abs err {err:.3e} vs scale "
                             f"{scale:.3e} exceeds rel tol {TOL[name]}")
    return err


# -- phases --------------------------------------------------------------------

def main_path(cases, dev) -> list:
    """PlanBuilder.build → execute_plan for every (matrix, ordering, k)."""
    from repro_torch.core.plan import PlanBuilder, execute_plan
    from repro_torch.kernels import launch_counts

    builder = PlanBuilder()
    rng = np.random.default_rng(0)
    plans = []
    for a, algorithms in cases:
        for alg in algorithms:
            plan = builder.build(a, alg)
            log(f"plan {a.name} n={a.n} nnz={a.nnz} {alg}: "
                f"{plan.meta['t_build']:.3f} s (reorder "
                f"{plan.meta['t_reorder']:.3f} s, symbolic "
                f"{plan.meta['t_symbolic']:.3f} s), nnz_L={plan.nnz_L}, "
                f"flops={plan.predicted_flops:.4g}")
            for k in (1, 8):
                b = rng.standard_normal(a.n if k == 1 else (a.n, k))
                before = launch_counts()
                r = execute_plan(a, plan, b, backend="pipelined",
                                 sweep="device", solve_dtype="fp32_refine",
                                 device=dev)
                res = rel_residual(a, r["x"], b)
                sp = r["spans"]
                log(f"solve {a.name} {alg} k={k}: residual {res:.3e}, "
                    f"refine iterations {r['refine_iterations']}, converged "
                    f"{r['refine_converged']}; s: permute "
                    f"{sp['permute']:.4f}, factor {r['t_factor']:.4f} "
                    f"(factor.schedule {sp['factor.schedule']:.4f}, "
                    f"factor.assemble {sp['factor.assemble']:.4f}, "
                    f"factor.device {sp['factor.device']:.4f}), solve "
                    f"{r['t_solve']:.4f} (solve.setup {sp['solve.setup']:.4f},"
                    f" solve.sweep {sp['solve.sweep']:.4f}, solve.refine "
                    f"{sp['solve.refine']:.4f}), overlap "
                    f"{r['overlap_efficiency']:.3f}; launches "
                    f"{ {n: c - before[n] for n, c in launch_counts().items()} }")
                if not (res <= 1e-10 and r["refine_converged"]):
                    raise AssertionError(f"{a.name}/{alg}/k={k}: residual "
                                         f"{res:.3e}, converged "
                                         f"{r['refine_converged']}")
            plans.append((a, plan))
    return plans


def profile_solve(a, plan, dev) -> None:
    """Device busy share of one warm ``execute_plan`` (one RHS): the union of
    the CUDA kernel and copy intervals that ``torch.profiler`` records (device
    activity only), over the host wall time of the profiled call, which
    includes the profiler's own overhead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.plan import execute_plan

    b = np.random.default_rng(2).standard_normal(a.n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        execute_plan(a, plan, b, device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    busy, end, by_name = 0.0, float("-inf"), {}
    for s0, s1, name in spans:
        busy += max(0.0, s1 - max(s0, end))
        end = max(end, s1)
        by_name[name] = by_name.get(name, 0.0) + (s1 - s0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile {a.name} {plan.algorithm} k=1: wall {wall:.4f} s, device "
        f"busy {busy / 1e6:.4f} s ({busy / 1e6 / wall:.4f} of wall), "
        f"{len(spans)} device events; top (s): "
        + json.dumps({n[:60]: round(t / 1e6, 6) for n, t in top}))


def pick_buckets(schedule, routes) -> dict:
    """(level, bucket) keys: the most populated and the largest bucket, and
    the same among buckets that receive extend-add contributions."""
    keys = [(li, bj) for li in range(schedule.nlevels)
            for bj in range(len(schedule.buckets[li]))]
    size = lambda k: len(schedule.buckets[k[0]][k[1]].members)  # noqa: E731
    width = lambda k: schedule.buckets[k[0]][k[1]].M  # noqa: E731
    fed = [k for k in keys if k in routes]
    return {"populated": max(keys, key=size), "largest": max(keys, key=width),
            "populated_fed": max(fed, key=size),
            "largest_fed": max(fed, key=width)}


def kernel_checks(a, plan, dev) -> dict:
    """Each kernel against its plain version at the 32³ schedule's shapes,
    on the inputs the main path gives it, with times and bounds. Returns
    {kernel: record}; the record kept for the ``kernels`` line is the one of
    the largest bucket (one RHS, lower sweep)."""
    import warnings

    import torch

    from repro_torch.device import to_device
    from repro_torch.kernels import frontal_cholesky as fc
    from repro_torch.kernels import ops
    from repro_torch.kernels.spmv_bell import (bell_spmv, bell_spmv_plain,
                                               csr_to_bell)
    from repro_torch.sparse.csr import permute_symmetric
    from repro_torch.sparse.multifrontal import (_assemble_bucket,
                                                 _route_contributions,
                                                 multifrontal_cholesky)

    pa = permute_symmetric(a, plan.perm)
    f = multifrontal_cholesky(pa, sym=plan.sym, device=dev)
    sched = f.schedule
    routes = _route_contributions(sched)
    picks = pick_buckets(sched, routes)
    log("schedule " + json.dumps({k: f.stats[k] for k in (
        "nsup", "nlevels", "nbatches", "peak_front", "front_flops",
        "occupancy")}) + " buckets " + json.dumps(
        {t: [len(sched.buckets[li][bj].members), sched.buckets[li][bj].P,
             sched.buckets[li][bj].R] for t, (li, bj) in picks.items()}))
    rng = np.random.default_rng(1)
    out: dict = {}

    def record(name, shape, err, ms, plain_ms, lib_ms, flops, nbytes, peak,
               headline):
        bms, by = bound(flops, nbytes, peak)
        log(f"kernel {name} {shape}: max_abs_err {err:.3e}, ms {ms:.5f}, "
            f"plain_ms {plain_ms:.5f}, bound_ms {bms:.5f} ({by}), "
            f"library_ms {lib_ms if lib_ms is None else f'{lib_ms:.5f}'}")
        rec = out.setdefault(name, dict(max_abs_err=0.0))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if headline:
            rec.update(name=name, route="cuda", source=SOURCE[name],
                       replaces=REPLACES[name], ms=ms, plain_ms=plain_ms,
                       bound_ms=bms, bound_by=by, library_ms=lib_ms)

    def bucket_inputs(key):
        """The bucket's assembled workspaces, and its extend-add groups
        (source stack, offset, src, dst, rows) from the factored stacks."""
        bk = sched.buckets[key[0]][key[1]]
        w0 = to_device(_assemble_bucket(pa, sched, bk), dev)
        groups = []
        for skey, contribs in sorted(routes.get(key, {}).items()):
            contribs.sort(key=lambda c: c[1])
            groups.append((f.device_stacks[skey],
                           sched.buckets[skey[0]][skey[1]].P,
                           np.array([c[0] for c in contribs], np.int32),
                           np.array([c[1] for c in contribs], np.int32),
                           np.stack([c[2] for c in contribs])))
        return bk, w0, groups

    # extend_add_batch: a bucket's real contributions, read from the
    # factored stacks of the factorization above
    for tag in ("populated_fed", "largest_fed"):
        bk, w0, groups = bucket_inputs(picks[tag])
        wk, wp, wl = w0.clone(), w0.clone(), w0.clone()

        def run_kernel():
            for u, off, src, dst, rows in groups:
                fc.extend_add_batch(wk, u, dst, rows, src=src, off=off)

        def run_plain():
            for u, off, src, dst, rows in groups:
                fc.extend_add_batch_plain(wp, u, dst, rows, src, off)

        run_kernel()
        run_plain()
        err = compare("extend_add_batch", wk, wp)
        # the library call: one index_put_(accumulate=True) of every entry
        di, ri, ci, vals = [], [], [], []
        for u, off, src, dst, rows in groups:
            for c in range(rows.shape[0]):
                act = np.flatnonzero(rows[c] >= 0)
                r = rows[c][act]
                di.append(np.full(act.size ** 2, dst[c]))
                ri.append(np.repeat(r, act.size))
                ci.append(np.tile(r, act.size))
                vals.append(u[int(src[c]), off + act[:, None],
                              off + act[None, :]].reshape(-1))
        pos = np.stack([np.concatenate(v) for v in (di, ri, ci)])
        idx = tuple(to_device(p.astype(np.int64), dev) for p in pos)
        vals_t = torch.cat(vals)
        n_u, touched = pos.shape[1], np.unique(pos, axis=1).shape[1]
        ms = device_ms(run_kernel, setup=lambda: wk.copy_(w0))
        pms = stream_ms(run_plain, setup=lambda: wp.copy_(w0))
        lms = device_ms(lambda: wl.index_put_(idx, vals_t, accumulate=True),
                        setup=lambda: wl.copy_(w0))
        # each active U entry read once, each touched W entry read and
        # written once, the row maps and slot indices read once
        nbytes = n_u * 4 + touched * 8 + sum(g[4].size * 4 + 8 * g[2].size
                                             for g in groups)
        record("extend_add_batch",
               f"{tag} B={len(bk.members)} M={bk.M} groups={len(groups)} "
               f"C={sum(g[2].size for g in groups)} entries={n_u}",
               err, ms, pms, lms, n_u, nbytes, PEAK_FP32,
               tag == "largest_fed")

    # frontal_factor_batch on the workspaces the main path factors: A's
    # entries plus the children's Schur blocks
    for tag in ("populated", "largest"):
        bk, w0, groups = bucket_inputs(picks[tag])
        for u, off, src, dst, rows in groups:
            fc.extend_add_batch(w0, u, dst, rows, src=src, off=off)
        B, P, M = len(bk.members), bk.P, bk.M
        bs = ops.pick_block_size(P)
        wk, wp = w0.clone(), w0.clone()
        fc.frontal_factor_batch(wk, P, bs=bs)
        fc.frontal_factor_batch_plain(wp, P, bs)
        err = compare("frontal_factor_batch", torch.tril(wk), torch.tril(wp))
        ms = device_ms(lambda: fc.frontal_factor_batch(wk, P, bs=bs),
                       setup=lambda: wk.copy_(w0))
        pms = stream_ms(lambda: fc.frontal_factor_batch_plain(wp, P, bs),
                        setup=lambda: wp.copy_(w0))
        R = M - P
        flops = B * (P ** 3 / 3 + P * P * R + P * R * R)
        record("frontal_factor_batch", f"{tag} B={B} P={P} M={M} bs={bs}",
               err, ms, pms, None, flops, 2 * w0.numel() * 4, PEAK_FP32,
               tag == "largest")

    # tri_solve_batch on the factored L11 of each bucket, lower and upper
    for tag in ("populated", "largest"):
        li, bj = picks[tag]
        bk = sched.buckets[li][bj]
        B, P = len(bk.members), bk.P
        L = f.device_stacks[(li, bj)][:, :P, :P]
        Lt = torch.tril(L).contiguous()
        bs = ops.pick_block_size(P)
        for k in (1, 8):
            x0 = torch.as_tensor(rng.standard_normal((B, P, k)),
                                 dtype=torch.float32, device=dev)
            for lower in (True, False):
                xk, xp = x0.clone(), x0.clone()
                fc.tri_solve_batch(L, xk, bs=bs, kt=k, lower=lower)
                fc.tri_solve_batch_plain(L, xp, bs, lower)
                err = compare("tri_solve_batch", xk, xp)
                ms = device_ms(lambda: fc.tri_solve_batch(
                    L, xk, bs=bs, kt=k, lower=lower),
                    setup=lambda: xk.copy_(x0))
                pms = stream_ms(lambda: fc.tri_solve_batch_plain(
                    L, xp, bs, lower), setup=lambda: xp.copy_(x0))
                lms = device_ms(lambda: torch.linalg.solve_triangular(
                    Lt if lower else Lt.transpose(1, 2), x0, upper=not lower))
                flops = B * P * P * k
                nbytes = B * (P * (P + 1) // 2 * 4 + 2 * P * k * 4)
                record("tri_solve_batch",
                       f"{tag} B={B} P={P} k={k} bs={bs} "
                       f"{'lower' if lower else 'upper'}",
                       err, ms, pms, lms, flops, nbytes, PEAK_FP32,
                       tag == "largest" and k == 1 and lower)

    # bell_spmv over the permuted matrix's fp64 blocks (the residual's)
    blocks, idxa, npad = csr_to_bell(pa.indptr, pa.indices, pa.data, pa.n, 8)
    blocks_d, idx_d = to_device(blocks, dev), to_device(idxa, dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # "beta" CSR notice
        A_csr = torch.sparse_csr_tensor(
            torch.as_tensor(pa.indptr, dtype=torch.int64),
            torch.as_tensor(pa.indices, dtype=torch.int64),
            torch.as_tensor(pa.data, dtype=torch.float64),
            size=pa.shape, check_invariants=True).to(dev)
    for k in (1, 8):
        x = torch.zeros((npad, k), dtype=torch.float64, device=dev)
        x[:pa.n] = torch.as_tensor(rng.standard_normal((pa.n, k)), device=dev)
        yk = bell_spmv(blocks_d, idx_d, x)
        err = compare("bell_spmv", yk, bell_spmv_plain(blocks_d, idx_d, x))
        ref = torch.as_tensor(pa.matvec(x[:pa.n].cpu().numpy()), device=dev)
        compare("bell_spmv", yk[:pa.n], ref)
        xs = x[:pa.n].contiguous()
        ms = device_ms(lambda: bell_spmv(blocks_d, idx_d, x))
        pms = stream_ms(lambda: bell_spmv_plain(blocks_d, idx_d, x))
        lms = device_ms(lambda: torch.sparse.mm(A_csr, xs))
        # every stored block (ELL padding included), the indices, x and y
        nbytes = blocks.nbytes + idxa.nbytes + 2 * x.numel() * 8
        record("bell_spmv",
               f"nrb={blocks.shape[0]} max_k={blocks.shape[1]} bs=8 k={k}",
               err, ms, pms, lms, 2 * blocks.size * k, nbytes, PEAK_FP64,
               k == 1)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels._build import load_kernels
    from repro_torch.sparse.dataset import grid3d

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    load_kernels()
    log(f"build: {time.perf_counter() - t0:.1f} s (4 CUDA kernels, sm_90a)")

    g20 = grid3d(20, 20, 20, "grid3d_20")
    g32 = grid3d(32, 32, 32, "grid3d_32")
    reset_launch_counts()
    plans = main_path([(g20, ["amd", "scotch", "nd", "rcm"]), (g32, ["nd"])],
                      dev)
    counts = launch_counts()
    log("kernels " + json.dumps({"launches": counts}))
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")

    a, plan = plans[-1]
    records = kernel_checks(a, plan, dev)
    profile_solve(a, plan, dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{key: dict(records[name], launches=counts[name])[key]
                for key in keys} for name in REPLACES]
    log(f"total: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
