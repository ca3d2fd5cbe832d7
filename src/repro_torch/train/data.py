"""Port of ``repro/train/data.py``: :class:`SyntheticData` (:27) and
``input_specs`` (:76), the deterministic synthetic data pipeline.

Every batch is a pure function of (seed, step), drawn with numpy exactly
as the reference draws it, so both packages train on the same bits and a
restart needs no iterator state. Token streams are Zipf-distributed;
embedding-mode archs (the VLM and audio stubs) get unit-variance
embeddings; Qwen2-VL also gets stub M-RoPE position ids shaped like a (t,
h, w) grid traversal. The arrays keep the reference's dtypes (int32
tokens, labels and positions, float32 embeddings) and come back as tensors
on the data's device. ``input_specs`` gives ``device="meta"`` tensors
where the reference gives ``ShapeDtypeStruct``\\ s.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig, ShapeSpec

__all__ = ["SyntheticData", "input_specs"]


class SyntheticData:
    """Batches of ``shape`` for ``cfg`` from ``seed``, as tensors on
    ``device`` (default: the card)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                 device=None):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.device = resolve_device(device)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        cfg, shp = self.cfg, self.shape
        rng = np.random.default_rng((self.seed << 20) ^ step)
        b, s = shp.global_batch, shp.seq_len
        out: Dict[str, np.ndarray] = {}
        if cfg.input_mode == "tokens":
            # Zipf tokens clipped to vocab (power-law like natural text)
            toks = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
            toks = np.minimum(toks - 1, cfg.vocab_size - 1).astype(np.int32)
            out["tokens"] = toks[:, :-1]
            out["labels"] = toks[:, 1:].astype(np.int32)
        else:
            out["embeds"] = rng.standard_normal((b, s, cfg.d_model)
                                                ).astype(np.float32)
            out["labels"] = rng.integers(0, cfg.vocab_size, (b, s)
                                         ).astype(np.int32)
            if cfg.mrope:
                out["positions3"] = _stub_mrope_positions(b, s)
        return {k: _tensor(v, self.device) for k, v in out.items()}

    def decode_batch(self, step: int) -> torch.Tensor:
        """One decode token per sequence (or one embedding)."""
        cfg, shp = self.cfg, self.shape
        rng = np.random.default_rng((self.seed << 21) ^ step)
        b = shp.global_batch
        if cfg.input_mode == "tokens":
            out = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        else:
            out = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        return _tensor(out, self.device)


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _stub_mrope_positions(b: int, s: int) -> np.ndarray:
    """(3, B, S): a text prefix then a fake image grid (t=const, h/w raster)."""
    text = s // 2
    grid = s - text
    side = max(int(np.sqrt(grid)), 1)
    t = np.concatenate([np.arange(text), np.full(grid, text)])
    h = np.concatenate([np.arange(text),
                        text + (np.arange(grid) // side)])
    w = np.concatenate([np.arange(text),
                        text + (np.arange(grid) % side)])
    pos = np.stack([t, h, w]).astype(np.int32)          # (3, S)
    return np.broadcast_to(pos[:, None], (3, b, s)).copy()


def input_specs(cfg: ModelConfig, shape: ShapeSpec
                ) -> Dict[str, torch.Tensor]:
    """``device="meta"`` stand-ins of a batch (no allocation): shapes and
    dtypes only."""
    b, s = shape.global_batch, shape.seq_len

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        if cfg.input_mode == "tokens":
            return {"tokens": meta((b, 1))}
        return {"embeds": meta((b, 1, cfg.d_model), torch.float32)}
    out: Dict[str, Any] = {}
    if cfg.input_mode == "tokens":
        out["tokens"] = meta((b, s))
    else:
        out["embeds"] = meta((b, s, cfg.d_model), torch.float32)
        if cfg.mrope:
            out["positions3"] = meta((3, b, s))
    if shape.kind == "train":
        out["labels"] = meta((b, s))
    return out
