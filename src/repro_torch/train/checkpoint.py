"""Port of ``repro/train/checkpoint.py``: ``save_checkpoint`` (:45),
``restore_checkpoint`` (:86) and ``latest_step`` (:78), atomic,
manifest-described, resumable checkpoints.

Each named tree is one ``.npz`` of its leaves, keyed by their paths in the
port's nested dicts and lists (``layers::3::attn::wq``); a ``manifest.json``
records the step, each leaf's shape and true dtype, and an ``extra`` dict.
npz cannot hold bfloat16, so such a leaf is stored as its ``uint16`` bits
with ``bfloat16`` recorded. The write is atomic (a ``.tmp`` directory,
then ``os.rename``), a leftover ``.tmp`` directory is never read, and only
the newest ``keep_last`` checkpoints are kept. A restore returns tensors on
the devices of the template's leaves.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_SEP = "::"
#: torch dtype → the name recorded in the manifest (numpy's names)
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.bfloat16: "bfloat16", torch.float16: "float16",
          torch.int32: "int32", torch.int64: "int64", torch.bool: "bool",
          torch.uint8: "uint8", torch.int8: "int8", torch.int16: "int16"}
_DTYPES = {v: k for k, v in _NAMES.items()}


def _paths(tree: Any, prefix: Tuple[str, ...] = ()):
    """(path key, leaf) for every leaf of a nested dict/list, dict keys in
    sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield _SEP.join(prefix), tree


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    t = torch.as_tensor(leaf).detach().cpu()
    name = _NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_numpy(arr: np.ndarray, name: str, device) -> torch.Tensor:
    if name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, dtype=name))
    return t.to(device)


def save_checkpoint(ckpt_dir: str, step: int, trees: Dict[str, Any],
                    keep_last: int = 3, extra: Optional[dict] = None) -> str:
    """Write ``trees`` (name → nested dict/list of tensors) as checkpoint
    ``step`` under ``ckpt_dir``; returns its directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "trees": {}, "extra": extra or {}}
    for name, tree in trees.items():
        flat, meta = {}, {}
        for key, leaf in _paths(tree):
            arr, dtype = _to_numpy(leaf)
            flat[key] = arr
            meta[key] = dict(shape=list(arr.shape), dtype=dtype)
        np.savez(os.path.join(tmp, f"{name}.npz"), **flat)
        manifest["trees"][name] = meta
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _rebuild(template: Any, leaf_fn, prefix: Tuple[str, ...] = ()):
    if isinstance(template, dict):
        return {k: _rebuild(v, leaf_fn, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaf_fn, prefix + (str(i),))
                              for i, v in enumerate(template))
    return leaf_fn(_SEP.join(prefix), template)


def restore_checkpoint(ckpt_dir: str, templates: Dict[str, Any],
                       step: Optional[int] = None, device=None
                       ) -> Tuple[int, Dict[str, Any], dict]:
    """templates: name → nested dict/list with the target structure; each
    leaf gives its shape and, when it is a tensor, the device its restored
    value goes to (the CPU otherwise), unless ``device`` is given, which
    then takes every leaf. Returns (step, trees, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out: Dict[str, Any] = {}
    for name, template in templates.items():
        meta = manifest["trees"][name]
        with np.load(os.path.join(d, f"{name}.npz")) as z:
            def leaf(key, tmpl):
                arr = z[key]
                assert tuple(arr.shape) == tuple(tmpl.shape), (
                    key, arr.shape, tuple(tmpl.shape))
                dev = device if device is not None else (
                    tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu")
                return _from_numpy(arr, meta[key]["dtype"], dev)

            out[name] = _rebuild(template, leaf)
    return step, out, manifest.get("extra", {})
