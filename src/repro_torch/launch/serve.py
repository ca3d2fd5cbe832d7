"""Port of ``repro/launch/serve.py``: prefill a batch of requests, then
batched greedy decode, with per-phase latency.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --prompt-len 4096 --decode-steps 16 --batch 4 [--devices N
        [--data-par N] [--model-par N]] [--device cuda|cpu]

The reference's flags, plus ``--device`` (default ``cuda``; ``cpu`` runs
the plain versions of the kernels). Weights are random, drawn from a
``torch.Generator`` seeded with 0 on the device (the reference draws from
``PRNGKey(0)``); the prompt comes from ``np.random.default_rng(0)`` as
there. A prompt longer than 2,048 takes the chunked attention branch, which
on the card is the flash-attention kernel.

``--devices N`` serves over an N-rank (data, model) mesh of ``--data-par``
× ``--model-par`` (the data width defaults to devices // model_par), as
the reference's docstring promises and its dry run builds: the launcher
starts the ranks itself (gloo processes for ``--device cpu``, NCCL with one
card a rank for ``cuda``), lays the parameters out as the mesh trainer does
(``param_specs`` with ``kv_whole_specs``), the batch over the data axes
when it tiles them, and the cache by ``cache_specs``, whose length is
rounded up to a multiple of the sequence's shards. ``decode_seq_axes``
follows the reference dry run's decode rule with ``seq_shard_decode`` on
(:func:`repro_torch.distributed.sharding.decode_seq_axes_for`), so a batch
of 1 decodes from a sequence-sharded cache through
``sharded_decode_attention``. Rank 0 prints the same two lines as one
device does. A split whose product is not ``--devices``, or more ranks
than the machine has cards, exits with an error (code 2).
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..device import resolve_device
from ..models import decode_step, init_params, prefill
from ..models.config import ModelConfig

__all__ = ["make_batch", "serve", "mesh_layout", "serve_on_mesh", "main"]


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


def serve(cfg: ModelConfig, params, batch: dict, decode_steps: int,
          max_seq: Optional[int] = None) -> dict:
    """Greedy prefill → ``decode_steps`` decode steps. Returns the prefill's
    logits, the last step's logits, the sampled tokens (B, decode_steps)
    and the seconds of each phase (each ends in a sync; every sampled token
    is copied to the host as it is produced). ``max_seq``: the cache's
    length (default: the prompt's plus ``decode_steps``)."""
    x = next(iter(batch.values()))
    b, s = x.shape[:2]
    _sync(x.device)
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, batch,
                            max_seq=max_seq or s + decode_steps)
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


def mesh_layout(cfg: ModelConfig, mesh, global_batch: int, max_seq: int):
    """How ``repro_torch.launch.serve --devices`` serves ``global_batch``
    rows with a cache of at least ``max_seq`` positions over ``mesh``'s
    (``data``, ``model``) axes: the
    :class:`~repro_torch.distributed.meshctx.MeshContext` (parameter specs
    as the mesh trainer lays them out, ``cache_specs``, ``decode_seq_axes``
    by the dry run's decode rule with ``seq_shard_decode`` on, the only
    plan under which the port decodes a cache whose sequence is split),
    the batch's spec, and ``max_seq`` rounded up to a multiple of the
    sequence's shards."""
    from ..distributed.meshctx import MeshContext
    from ..distributed.sharding import (ExecutionPlan, _batch_split,
                                        cache_specs, decode_seq_axes_for,
                                        kv_whole_specs, param_specs)
    from ..models.config import ShapeSpec

    plan = ExecutionPlan(seq_shard_decode=True)
    ctx = MeshContext(mesh)
    n_model = ctx.size("model")
    ctx.specs = kv_whole_specs(param_specs(
        init_params(cfg, None), cfg, plan, n_model=n_model), cfg, "model",
        n_model)
    shape = ShapeSpec("serve", max_seq, global_batch, "decode")
    ctx.cache_specs = cache_specs(cfg, shape, mesh)
    ctx.decode_seq_axes = decode_seq_axes_for(cfg, shape, mesh, plan)
    n_seq = ctx.size(ctx.decode_seq_axes) if ctx.decode_seq_axes else 1
    split = _batch_split(global_batch, ctx.size("data"))
    return ctx, "data" if split else None, -(-max_seq // n_seq) * n_seq


def serve_on_mesh(cfg: ModelConfig, params, batch: dict, decode_steps: int,
                  mesh) -> dict:
    """:func:`serve` over ``mesh`` from the logical ``params`` and
    ``batch``, laid out by :func:`mesh_layout` (each rank cuts its shards;
    every rank of the mesh calls this): the returned logits and tokens are
    the whole batch's, gathered over the data axis, and ``ctx`` the
    context it served under."""
    from ..distributed.meshctx import mesh_context
    from ..distributed.sharding import Sharding, map_specs, to_shardings

    x = next(iter(batch.values()))
    b, s = x.shape[:2]
    ctx, bspec, max_seq = mesh_layout(cfg, mesh, b, s + decode_steps)
    local = map_specs(lambda sh, t: sh.shard(t).contiguous(),
                      to_shardings(ctx.specs, ctx), params)
    rows = Sharding(ctx, (bspec,))
    lbatch = {k: (Sharding(ctx, (None, bspec)) if k == "positions3"
                  else rows).shard(v).contiguous() for k, v in batch.items()}
    with mesh_context(ctx):
        out = serve(cfg, local, lbatch, decode_steps, max_seq=max_seq)
    for k in ("prefill_logits", "logits"):
        out[k] = rows.gather(out[k])
    out["tokens"] = rows.gather(torch.as_tensor(
        out["tokens"], device=x.device)).cpu().numpy()
    out["ctx"] = ctx
    return out


def _report(cfg: ModelConfig, args, out: dict) -> None:
    t_prefill, t_decode = out["t_prefill"], out["t_decode"]
    print(f"[serve] {cfg.name}: prefill({args.batch}×{args.prompt_len}) "
          f"{t_prefill*1e3:.0f} ms; {args.decode_steps} decode steps "
          f"{t_decode*1e3:.0f} ms "
          f"({t_decode/max(args.decode_steps, 1)*1e3:.1f} ms/tok)")
    print("[serve] sampled tokens (seq 0):", out["tokens"][0].tolist())


def _config(args) -> ModelConfig:
    return (get_smoke_config if args.smoke else get_config)(args.arch)


def _rank(rank: int, args, dp: int, mp: int) -> None:
    """One rank of a mesh run (``run_ranks`` has joined it to the group)."""
    from .mesh import make_mesh

    dev = torch.device("cpu" if args.device == "cpu" else f"cuda:{rank}")
    mesh = make_mesh((dp, mp), ("data", "model"), dev)
    cfg = _config(args)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    batch = make_batch(cfg, args.batch, args.prompt_len, dev)
    out = serve_on_mesh(cfg, params, batch, args.decode_steps, mesh)
    if rank == 0:
        _report(cfg, args, out)


def main(argv: Optional[Sequence[str]] = None) -> Optional[dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen3-1.7b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--devices", type=int, default=1)
    p.add_argument("--data-par", type=int, default=0,
                   help="data axis size (default devices//model_par)")
    p.add_argument("--model-par", type=int, default=1)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--decode-steps", type=int, default=16)
    p.add_argument("--device", default="cuda")
    p.add_argument("--timeout", type=float, default=3600.0,
                   help="seconds the ranks of a mesh run may take")
    args = p.parse_args(argv)

    if args.devices == 1 and args.data_par <= 1 and args.model_par == 1:
        dev = resolve_device(args.device)
        cfg = _config(args)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        batch = make_batch(cfg, args.batch, args.prompt_len, dev)
        out = serve(cfg, params, batch, args.decode_steps)
        _report(cfg, args, out)
        return out

    mp = args.model_par
    dp = args.data_par or args.devices // max(mp, 1)
    if args.devices < 1 or mp < 1 or dp * mp != args.devices:
        p.error(f"data_par × model_par must = devices: {dp} × {mp} != "
                f"{args.devices}")
    if args.device != "cpu" and args.devices > torch.cuda.device_count():
        p.error(f"--devices {args.devices}: the machine has "
                f"{torch.cuda.device_count()} CUDA devices (one a rank)")
    from .mesh import run_ranks

    store = tempfile.mkdtemp(prefix="repro_torch_serve_")
    try:
        run_ranks(_rank, args.devices, store, args=(args, dp, mp),
                  device=args.device, timeout=args.timeout)
    finally:
        import shutil

        shutil.rmtree(store, ignore_errors=True)
    return None


if __name__ == "__main__":
    main()
