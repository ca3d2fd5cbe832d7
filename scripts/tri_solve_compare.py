"""Time one source tree's ``tri_solve_batch`` on the card, so that two trees
can be compared in one machine session.

Run from the root of the repository, on a machine with one CUDA device:

    python3 scripts/tri_solve_compare.py [--src DIR]

``DIR`` (default: this checkout's ``src``) goes first on ``sys.path``, so
the port of an older commit unpacked under ``build/`` is timed by the same
code; its kernels build into that tree's own ``build/torch_kernels``. On
grid3d(32,32,32) under ``nd`` (the solve path of ``chip_smoke.py``) it runs
``execute_plan`` (pipelined, device sweeps, fp32 factors with fp64
refinement, one RHS) once to warm up and ``RUNS`` more times, keeping each
``solve.sweep`` span; profiles one more run and sums the device time of the
tri-solve kernels by name; then runs ``chip_smoke.tri_solve_check`` (the
kernel held against its plain version, timed beside it and
``solve_triangular``) on the factored L11 of the populated and the largest
bucket, at one RHS and eight, both sweeps. Prints one JSON line; exits 2
without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = 5


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the source tree whose repro_torch is timed")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("tri_solve_compare: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.abspath(args.src)
    sys.path[:0] = [src, ROOT]
    import chip_smoke as cs
    from repro_torch.core.plan import PlanBuilder, execute_plan
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import load_kernels
    from repro_torch.sparse.csr import permute_symmetric
    from repro_torch.sparse.dataset import grid3d
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
    sweeps = [solve()["spans"]["solve.sweep"] for _ in range(RUNS)]
    tri = cs.tri_solve_device_s(cs.profile_call("execute_plan", solve))

    f = multifrontal_cholesky(permute_symmetric(a, plan.perm), sym=plan.sym,
                              device=dev)
    picks = cs.pick_buckets(f.schedule, _route_contributions(f.schedule))
    rng = np.random.default_rng(1)
    kernel = {}
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
                kernel[f"{shape} k={k} {'lower' if lower else 'upper'}"] = \
                    cs.tri_solve_check({}, shape, L, x0, bs, k, lower, False)
    print(json.dumps({"src": os.path.relpath(src, ROOT),
                      "device": torch.cuda.get_device_name(0),
                      "solve.sweep": sweeps, "tri_solve_device_s": tri,
                      "kernel": kernel}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
