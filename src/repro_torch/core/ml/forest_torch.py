"""Port of ``repro/core/ml/forest_jnp.py``: decision-tree / random-forest
inference on the card.

``tree_to_arrays``, ``arrays_to_tree`` and ``forest_to_arrays`` are copied:
a fitted tree flattens into dense node arrays (feature, threshold, left,
right, leaf probabilities). :func:`forest_forward_device` (the port of
``forest_forward_jnp``, :125) evaluates a whole forest on a feature batch by
level-synchronous gathers: every sample in every tree descends one level per
step, leaves self-loop, and after ``depth`` steps each sample sits at its
leaf. No host transfer and no Python recursion.

Numerics: thresholds and leaf probabilities are evaluated in float32, as
on the reference's device path. Fully-grown CART leaves are pure, so forest
votes are small exact integers and the argmax agrees with the float64 host
path; a sample within float32 rounding of a split threshold may route
differently.
"""
from __future__ import annotations

import threading
from typing import List, NamedTuple

import numpy as np
import torch

__all__ = ["ForestArrays", "tree_to_arrays", "arrays_to_tree",
           "forest_to_arrays", "forest_forward_device", "forest_forward"]


class ForestArrays(NamedTuple):
    """Flattened forest: ``(T, N)`` node arrays padded to the widest tree.

    ``left``/``right`` are in-tree node indices; leaves (and padding) point
    at themselves so extra traversal steps are no-ops. ``value`` holds the
    normalized class distribution of each node's training samples (only
    leaf rows are ever gathered).
    """

    feature: np.ndarray    # (T, N) int32
    threshold: np.ndarray  # (T, N) float32
    left: np.ndarray       # (T, N) int32
    right: np.ndarray      # (T, N) int32
    value: np.ndarray      # (T, N, k) float32
    depth: int             # max levels over all trees


def tree_to_arrays(root, n_classes: int, normalize: bool = True):
    """DFS-flatten one linked `_Node` tree into parallel lists.

    Returns (feature, threshold, left, right, value, depth) python lists —
    the forest packer pads and stacks them. ``normalize=False`` keeps the
    raw class counts (the persistence path uses it: renormalizing is not
    bit-stable, and fingerprints must survive a save/load round trip).
    """
    feats: List[int] = []
    thrs: List[float] = []
    lefts: List[int] = []
    rights: List[int] = []
    values: List[np.ndarray] = []
    depth = 0
    # explicit stack: grid-search trees can outgrow Python's recursion limit
    stack = [(root, None, False, 0)]  # (node, parent_idx, is_right, level)
    while stack:
        node, parent, is_right, level = stack.pop()
        i = len(feats)
        depth = max(depth, level)
        is_leaf = node.left is None
        feats.append(0 if is_leaf else node.feature)
        thrs.append(np.inf if is_leaf else node.threshold)
        lefts.append(i)   # self-loop; patched below for internal nodes
        rights.append(i)
        val = np.asarray(node.value, dtype=np.float64)
        assert val.shape == (n_classes,), (val.shape, n_classes)
        values.append(val / max(float(val.sum()), 1.0) if normalize
                      else val)
        if parent is not None:
            (rights if is_right else lefts)[parent] = i
        if not is_leaf:
            # push right first so left is visited (and indexed) first
            stack.append((node.right, i, True, level + 1))
            stack.append((node.left, i, False, level + 1))
    return feats, thrs, lefts, rights, values, depth


def arrays_to_tree(feature, threshold, left, right, value):
    """Inverse of :func:`tree_to_arrays`: rebuild the linked ``_Node`` tree
    from parallel node arrays (leaves are the self-looping rows). Used by
    ``DecisionTreeClassifier.load_state`` so persisted bundles stay
    array-only. Iterative — no recursion limit to outgrow."""
    from .decision_tree import _Node

    nodes = [_Node(np.asarray(value[i], dtype=np.float64))
             for i in range(len(feature))]
    for i, node in enumerate(nodes):
        li, ri = int(left[i]), int(right[i])
        if li != i or ri != i:
            node.feature = int(feature[i])
            node.threshold = float(threshold[i])
            node.left = nodes[li]
            node.right = nodes[ri]
    return nodes[0]


def forest_to_arrays(trees, n_classes: int) -> ForestArrays:
    """Pack fitted trees (objects with ``root_``) into one padded stack."""
    flat = [tree_to_arrays(t.root_, n_classes) for t in trees]
    nmax = max(len(f[0]) for f in flat)
    T = len(flat)
    feature = np.zeros((T, nmax), dtype=np.int32)
    threshold = np.full((T, nmax), np.inf, dtype=np.float32)
    left = np.tile(np.arange(nmax, dtype=np.int32), (T, 1))
    right = left.copy()
    value = np.zeros((T, nmax, n_classes), dtype=np.float32)
    depth = 0
    for t, (f, th, lf, rg, vals, d) in enumerate(flat):
        m = len(f)
        feature[t, :m] = f
        threshold[t, :m] = th
        left[t, :m] = lf
        right[t, :m] = rg
        value[t, :m] = np.stack(vals)
        depth = max(depth, d)
    return ForestArrays(feature, threshold, left, right, value, depth)


def forest_forward_device(fa: ForestArrays, x: torch.Tensor,
                          tensors=None) -> torch.Tensor:
    """Mean leaf probabilities ``(B, k)`` for a ``(B, d)`` feature batch, on
    the device of ``x``.

    Level-synchronous traversal: ``node[t, b]`` descends one edge per step
    via gathers of feature, threshold and child over the ``(T, N)`` node
    arrays, for all trees at once. ``tensors`` are ``fa``'s arrays already
    on ``x``'s device (as :func:`forest_forward` caches them); without them
    the arrays are uploaded for this call.
    """
    x = x.to(torch.float32)
    if tensors is None:
        tensors = _upload(fa, x.device)
    feature, threshold, left, right, value = tensors
    T, B = feature.shape[0], x.shape[0]
    node = torch.zeros((T, B), dtype=torch.int64, device=x.device)
    cols = torch.arange(B, device=x.device).expand(T, B)
    for _ in range(fa.depth):
        f = torch.gather(feature, 1, node)                   # (T, B)
        t = torch.gather(threshold, 1, node)
        xv = x[cols, f]                                      # x[b, f[t, b]]
        node = torch.where(xv <= t, torch.gather(left, 1, node),
                           torch.gather(right, 1, node))
    trees = torch.arange(T, device=x.device)[:, None]
    return value[trees, node].mean(dim=0)                    # (B, k)


def _upload(fa: ForestArrays, device: torch.device) -> tuple:
    """``fa``'s node arrays as tensors on ``device`` (indices as int64, the
    index type of ``torch.gather``)."""
    return tuple(torch.as_tensor(a, dtype=dt).to(device) for a, dt in (
        (fa.feature, torch.int64), (fa.threshold, torch.float32),
        (fa.left, torch.int64), (fa.right, torch.int64),
        (fa.value, torch.float32)))


#: guards every model's ``_flat`` cache: the serving plane selects from its
#: batcher thread and from RPC connection threads at once
_FLAT_LOCK = threading.Lock()


def _cached_arrays(model, trees, device: torch.device):
    """Flatten once per fit and upload once per device: keyed on the
    identity of the fitted roots.

    The key holds strong references to the root nodes (not their ``id``s):
    a refit frees the old roots, and a reallocated node could otherwise
    reuse an address and alias the stale arrays. Returns the host arrays
    and their tensors on ``device``. The check and the fill run under one
    lock, so concurrent first calls flatten and upload once and all get the
    same tensors; the forward itself runs outside it.
    """
    key = tuple(t.root_ for t in trees)
    with _FLAT_LOCK:
        cached = getattr(model, "_flat", None)
        if (cached is None or len(cached[0]) != len(key)
                or any(a is not b for a, b in zip(cached[0], key))):
            cached = model._flat = (
                key, forest_to_arrays(trees, int(model.n_classes_)), {})
        fa, per_device = cached[1], cached[2]
        if device not in per_device:
            per_device[device] = _upload(fa, device)
        return fa, per_device[device]


def forest_forward(model, x: torch.Tensor) -> torch.Tensor:
    """``forward_device`` implementation shared by the tree and forest
    classes.

    ``model`` is a fitted ``DecisionTreeClassifier`` (``root_``) or
    ``RandomForestClassifier`` (``trees_``).
    """
    trees = getattr(model, "trees_", None)
    if trees is None:
        trees = [model]
    fa, tensors = _cached_arrays(model, trees, x.device)
    return forest_forward_device(fa, x, tensors)
