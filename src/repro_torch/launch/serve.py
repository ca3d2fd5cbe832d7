"""Port of ``repro/launch/serve.py``: prefill a batch of requests, then
batched greedy decode, with per-phase latency.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --prompt-len 4096 --decode-steps 16 --batch 4

The reference's flags, plus ``--device`` (default ``cuda``; ``cpu`` runs
the plain versions of the kernels). Weights are random, drawn from a
``torch.Generator`` seeded with 0 on the device (the reference draws from
``PRNGKey(0)``); the prompt comes from ``np.random.default_rng(0)`` as
there. A prompt longer than 2,048 takes the chunked attention branch, which
on the card is the flash-attention kernel. ``--devices`` > 1 (the sharded
cache) waits for the serving mesh (ROADMAP §1, item 4).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..device import resolve_device
from ..models import decode_step, init_params, prefill
from ..models.config import ModelConfig

__all__ = ["make_batch", "serve", "main"]


def make_batch(cfg: ModelConfig, batch: int, prompt_len: int,
               device) -> dict:
    """The launcher's prompt: token ids, or frame/patch embeddings for the
    stub frontends, from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    if cfg.input_mode == "tokens":
        return {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
            device=device)}
    return {"embeds": torch.as_tensor(
        rng.standard_normal((batch, prompt_len, cfg.d_model)),
        dtype=torch.float32, device=device)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, params, batch: dict, decode_steps: int) -> dict:
    """Greedy prefill → ``decode_steps`` decode steps. Returns the prefill's
    logits, the last step's logits, the sampled tokens (B, decode_steps)
    and the seconds of each phase (each ends in a sync; every sampled token
    is copied to the host as it is produced)."""
    x = next(iter(batch.values()))
    b, s = x.shape[:2]
    _sync(x.device)
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, batch, max_seq=s + decode_steps)
    _sync(x.device)
    t_prefill = time.perf_counter() - t0
    prefill_logits = logits
    toks = []
    t0 = time.perf_counter()
    tok = logits.argmax(-1)[:, None]
    for _ in range(decode_steps):
        tok_in = (tok if cfg.input_mode == "tokens" else torch.zeros(
            (b, 1, cfg.d_model), dtype=torch.float32, device=x.device))
        logits, cache = decode_step(cfg, params, cache, tok_in)
        tok = logits.argmax(-1)[:, None]
        toks.append(tok[:, 0].cpu().numpy())
    _sync(x.device)
    t_decode = time.perf_counter() - t0
    return dict(prefill_logits=prefill_logits, logits=logits,
                tokens=np.stack(toks, axis=1) if toks else
                np.zeros((b, 0), np.int64),
                t_prefill=t_prefill, t_decode=t_decode)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-1.7b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--devices", type=int, default=1)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--decode-steps", type=int, default=16)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.devices > 1:
        raise NotImplementedError(
            "--devices > 1 (a sharded KV cache) waits for the serving mesh "
            "(ROADMAP §1, item 4)")

    dev = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    batch = make_batch(cfg, args.batch, args.prompt_len, dev)
    out = serve(cfg, params, batch, args.decode_steps)
    t_prefill, t_decode = out["t_prefill"], out["t_decode"]
    print(f"[serve] {cfg.name}: prefill({args.batch}×{args.prompt_len}) "
          f"{t_prefill*1e3:.0f} ms; {args.decode_steps} decode steps "
          f"{t_decode*1e3:.0f} ms "
          f"({t_decode/max(args.decode_steps, 1)*1e3:.1f} ms/tok)")
    print("[serve] sampled tokens (seq 0):", out["tokens"][0].tolist())
    return out


if __name__ == "__main__":
    main()
