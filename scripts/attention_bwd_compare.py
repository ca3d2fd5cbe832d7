"""Time one source tree's attention backward (``flash_attention_bwd``) on
the card, so that two trees can be compared in one machine session.

Run from the root of the repository, on a machine with one CUDA device:

    python3 scripts/attention_bwd_compare.py [--src DIR]

``DIR`` (default: this checkout's ``src``) goes first on ``sys.path``, so
the port of an older commit unpacked under ``build/`` is timed by the same
code; its kernels build into that tree's own ``build/torch_kernels``. On
seeded bf16 inputs at the training shape of llama3.2-1b (B 4, Hq 32, Hkv 8,
S 4,096, D 64, causal) and at the B 1 shapes of ``chip_smoke.py``'s
backward checks (llama3.2-1b, its ragged S 4,097, qwen3-1.7b at D 128,
rep 1) it runs the tree's forward (with the training statistics where the
tree has them) and backward, and times the backward
(``chip_smoke.device_ms``); at the training shape it also profiles five
backward calls and reports each kernel's device ms a call by name. It
also times the forward as serving calls it (no statistics) at the
prefill shapes of qwen3-1.7b (B 4, Hq 16, Hkv 8, S 4,096, D 128) and
llama3.2-1b (``fwd_ms``). A tree whose wrapper takes no ``lse`` runs its
first design. Prints one JSON line with the card's name and power limit;
exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (("training step", 4, 32, 8, 64, 4096),
         ("llama3.2-1b", 1, 32, 8, 64, 4096),
         ("llama3.2-1b ragged", 1, 32, 8, 64, 4097),
         ("qwen3-1.7b", 1, 16, 8, 128, 4096),
         ("rep 1", 1, 16, 16, 128, 4096))
FWD_CASES = (("qwen3-1.7b prefill", 4, 16, 8, 128, 4096),
             ("llama3.2-1b", 4, 32, 8, 64, 4096))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    args = ap.parse_args(argv)
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    sys.path.insert(1, ROOT)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("attention_bwd_compare: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import device_ms

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    stored = "lse" in inspect.signature(fa.flash_attention_bwd).parameters
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {"src": os.path.relpath(src, ROOT), "stored_stats": stored,
           "ms": {}, "kernels_ms": {}, "fwd_ms": {}}
    for tag, b, hq, hkv, d, s in CASES:
        q, k, v, dout = (torch.randn((b, h, s, d), generator=gen,
                                     device="cuda").bfloat16()
                         for h in (hq, hkv, hkv, hq))
        stats = {}
        if stored and fa.uses_stats(q):
            o, stats["lse"], stats["out_lo"] = fa.flash_attention(
                q, k, v, causal=True, stats=True)
        else:
            o = fa.flash_attention(q, k, v, causal=True)

        def bwd():
            return fa.flash_attention_bwd(q, k, v, o, dout, **stats)

        out["ms"][tag] = device_ms(bwd)
        if tag == "training step":
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    bwd()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                name = re.search(r"bwd_\w+<\d+>", e.key)
                if name and e.device_time_total > 0:
                    out["kernels_ms"][name.group(0)] = \
                        e.device_time_total / e.count / 1e3
        del q, k, v, dout, o, stats
        torch.cuda.empty_cache()
    for tag, b, hq, hkv, d, s in FWD_CASES:
        q, k, v = (torch.randn((b, h, s, d), generator=gen,
                               device="cuda").bfloat16()
                   for h in (hq, hkv, hkv))
        out["fwd_ms"][tag] = device_ms(
            lambda: fa.flash_attention(q, k, v, causal=True))
        del q, k, v
        torch.cuda.empty_cache()
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
