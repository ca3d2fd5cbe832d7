"""Port of the serving-mesh half of ``repro/distributed/meshctx.py``
(:88-207): :class:`ServingMesh`, the device layout of the selection-serving
plane, and the per-shard utilization report that
``PlanBuilder.select_names`` writes into the metrics registry.

In the reference the padded-CSR featurizer and the forest inference
shard_map over a 1-D mesh on the request-batch axis. The port serves on one
card: a :class:`ServingMesh` here is a list of ``torch.device``\\ s,
:func:`make_serving_mesh` raises for more devices than there are CUDA
devices (and ``EngineConfig`` refuses ``serving_devices > 1``), and the
degenerate one-device mesh is what :func:`get_serving_mesh` gives when none
is installed. The training half (``MeshContext``) is not ported.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import torch

from ..device import resolve_device

__all__ = ["ServingMesh", "make_serving_mesh", "set_serving_mesh",
           "get_serving_mesh", "record_shard_utilization"]


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """1-D mesh over the request-batch axis of the serving plane: the
    devices a padded batch is split over, contiguously."""

    devices: Tuple[torch.device, ...]

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    def shard_utilization(self, b_real: int, b_padded: int
                          ) -> List[Tuple[int, int]]:
        """Per-shard (real_rows, pad_rows) for a batch of ``b_real`` live
        requests padded to ``b_padded`` rows (padding lands on the tail
        shards)."""
        nd = self.num_devices
        if b_padded % nd:
            raise ValueError(
                f"padded batch {b_padded} does not divide over {nd} shards")
        per = b_padded // nd
        out = []
        for i in range(nd):
            real = min(per, max(0, b_real - i * per))
            out.append((real, per - real))
        return out


def make_serving_mesh(num_devices: Optional[int] = None,
                      device=None) -> ServingMesh:
    """Serving mesh over the first ``num_devices`` devices of the kind of
    ``device`` (``None`` → CUDA, raising when there is none; ``"cpu"`` → the
    one host device). Default: all of them."""
    dev = resolve_device(device)
    devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if dev.type == "cuda" else [dev])
    if num_devices is not None:
        if not 1 <= num_devices <= len(devs):
            raise ValueError(
                f"serving mesh wants {num_devices} devices but there are "
                f"{len(devs)} of type {dev.type}")
        devs = devs[:num_devices]
    return ServingMesh(tuple(devs))


_SERVING: Optional[ServingMesh] = None
_DEFAULT: Dict[str, ServingMesh] = {}
_DEFAULT_LOCK = threading.Lock()


def set_serving_mesh(sm: Optional[ServingMesh]) -> None:
    """Install the process-wide serving mesh (None → back to degenerate)."""
    global _SERVING
    _SERVING = sm


def get_serving_mesh(device=None) -> ServingMesh:
    """The installed serving mesh, else the degenerate one-device mesh on
    the kind of ``device`` (built once per kind: this sits on the
    per-micro-batch path)."""
    if _SERVING is not None:
        return _SERVING
    kind = resolve_device(device).type
    with _DEFAULT_LOCK:
        sm = _DEFAULT.get(kind)
        if sm is None:
            sm = _DEFAULT[kind] = make_serving_mesh(1, kind)
    return sm


def record_shard_utilization(metrics, sm: ServingMesh, b_real: int,
                             b_batch: int) -> None:
    """Report one device micro-batch's per-shard utilization into a
    :class:`repro_torch.core.metrics.MetricsRegistry`: ``mesh.shards``
    (gauge) and per-shard ``mesh.shard<i>.requests`` /
    ``mesh.shard<i>.pad_rows`` counters. ``b_batch`` is the batch the live
    rows were padded to (rounded up to a shard multiple)."""
    if metrics is None:
        return
    nd = sm.num_devices
    b_padded = -(-max(b_batch, b_real) // nd) * nd
    metrics.gauge("mesh.shards").set(nd)
    for i, (real, pad) in enumerate(sm.shard_utilization(b_real, b_padded)):
        metrics.counter(f"mesh.shard{i}.requests").inc(real)
        metrics.counter(f"mesh.shard{i}.pad_rows").inc(pad)

