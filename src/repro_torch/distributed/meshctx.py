"""Port of ``repro/distributed/meshctx.py``: the two mesh contexts that
model and serving code read.

* :class:`MeshContext` (:35), with ``set_mesh_context``,
  ``get_mesh_context`` and ``mesh_context`` (:58-81): the *training* and
  LM-serving mesh (a ``torch.distributed.device_mesh.DeviceMesh`` with the
  reference's axis names), its data axes and its model axis. The
  reference's model reads it only to keep the MoE dispatch local; the
  port's model runs on each rank's local shards with explicit collectives,
  so it reads the context to find its groups and the parameters' layout
  (``specs``, the layout the trainer or the serving launcher gave them:
  :mod:`repro_torch.distributed.sharding`). ``decode_seq_axes`` names the
  axes a decode's KV cache is sequence-sharded over
  (:func:`repro_torch.models.layers.sharded_decode_attention`). With no
  mesh set (``mesh=None``, the default) every function computes exactly
  what it computes on one device. The reference's ``attn_dp_axes`` and
  ``shard_activation_ckpt`` are set only by ``launch/dryrun.py`` and wait
  for it (ROADMAP item 3.3).
* :class:`ServingMesh` (:88-207), the device layout of the
  selection-serving plane, with ``make_serving_mesh``,
  ``set_serving_mesh``, ``get_serving_mesh``, the ``serving_mesh`` context
  manager and the per-shard utilization report that
  ``PlanBuilder.select_names`` writes into the metrics registry. The
  reference shard_maps the padded-CSR featurizer and the classifier over a
  1-D mesh on the request-batch axis; here a :class:`ServingMesh` is a
  tuple of ``torch.device``\\ s, one a shard, and the featurizer and
  ``ReorderSelector._predict_device`` split the padded batch contiguously
  over them, queueing every shard's work before any of it is read back.
  On the CPU, ``make_serving_mesh(n, "cpu")`` gives ``n`` shards on the
  one host device (the counterpart of the reference's
  ``--xla_force_host_platform_device_count``); a mesh may also list one
  card more than once. The degenerate one-device mesh is what
  :func:`get_serving_mesh` gives when none is installed.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import torch

from ..device import resolve_device

__all__ = ["MeshContext", "set_mesh_context", "get_mesh_context",
           "mesh_context", "register_groups", "ServingMesh",
           "make_serving_mesh", "set_serving_mesh", "get_serving_mesh",
           "serving_mesh", "installed_serving_mesh", "record_shard_utilization"]


# ---------------------------------------------------------------------------
# Training mesh
# ---------------------------------------------------------------------------

#: id(mesh) → (mesh, {axes: this rank's group over those axes}), filled by
#: ``repro_torch.launch.mesh.make_mesh``
_GROUPS: Dict[int, Tuple[object, Dict[Tuple[str, ...], object]]] = {}


def register_groups(mesh, groups: Dict[Tuple[str, ...], object]) -> None:
    """Record this rank's process group over each set of ``mesh``'s axes
    (keys: axis names in the mesh's order)."""
    _GROUPS[id(mesh)] = (mesh, dict(groups))


def _axes(entry) -> Tuple[str, ...]:
    """The axis names of a spec entry: ``None``, a name, or a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass
class MeshContext:
    """The training mesh threaded through model code. ``specs`` is the
    layout of the parameters the model is given (the trainer's spec tree,
    laid out like the parameters); ``None`` means every parameter is
    whole."""
    mesh: Optional[object]
    data_axes: Tuple[str, ...] = ("data",)   # ('pod', 'data') multi-pod
    model_axis: str = "model"
    specs: Optional[dict] = None
    # the axes a decode's KV cache is sequence-sharded over: decode then
    # runs layers.sharded_decode_attention over their group; None for a
    # cache whose sequence is whole on every rank
    decode_seq_axes: Optional[Tuple[str, ...]] = None
    # the layout of the cache the model serves from (sharding.cache_specs
    # at the global batch); needed by prefill and decode under a mesh
    cache_specs: Optional[dict] = None

    def _ordered(self, axes) -> Tuple[str, ...]:
        names = tuple(self.mesh.mesh_dim_names)
        axes = _axes(axes)
        unknown = [a for a in axes if a not in names]
        if unknown:
            raise ValueError(f"axes {unknown} are not in the mesh {names}")
        return tuple(a for a in names if a in axes)

    def size(self, axes) -> int:
        """The number of ranks along ``axes`` (a name or a tuple; 1 for
        none)."""
        n = 1
        for a in self._ordered(axes):
            n *= self.mesh.size(self.mesh.mesh_dim_names.index(a))
        return n

    def index(self, axes) -> int:
        """This rank's coordinate along ``axes``, row-major in the mesh's
        order (the order a tuple entry of a spec shards in)."""
        i = 0
        for a in self._ordered(axes):
            i = i * self.size(a) + self.mesh.get_local_rank(a)
        return i

    def group(self, axes):
        """This rank's process group over ``axes`` (in the mesh's order);
        raises unless the mesh was made by ``launch.mesh.make_mesh`` or
        ``axes`` is one axis."""
        axes = self._ordered(axes)
        entry = _GROUPS.get(id(self.mesh))
        if entry is not None and entry[0] is self.mesh:
            return entry[1][axes]
        if len(axes) == 1:
            return self.mesh.get_group(axes[0])
        raise ValueError(f"no process group over {axes}: make the mesh with "
                         f"repro_torch.launch.mesh.make_mesh")


_CURRENT = MeshContext(mesh=None)


def set_mesh_context(ctx: MeshContext) -> None:
    global _CURRENT
    _CURRENT = ctx


def get_mesh_context() -> MeshContext:
    return _CURRENT


class mesh_context:
    """with mesh_context(MeshContext(mesh, ...)): ..."""

    def __init__(self, ctx: MeshContext):
        self.ctx = ctx

    def __enter__(self):
        self.prev = get_mesh_context()
        set_mesh_context(self.ctx)
        return self.ctx

    def __exit__(self, *exc):
        set_mesh_context(self.prev)
        return False


# ---------------------------------------------------------------------------
# Serving mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """1-D mesh over the request-batch axis of the serving plane: the
    devices a padded batch is split over, contiguously, one shard a
    device (a device may appear more than once). Hashable: it keys the
    selector's per-mesh state."""

    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a serving mesh needs at least one device")
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1:
            raise ValueError(f"a serving mesh spans one kind of device, "
                             f"got {sorted(kinds)}")

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    @property
    def kind(self) -> str:
        """The device type of every shard (``cuda`` or ``cpu``)."""
        return self.devices[0].type

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
    """Serving mesh of ``num_devices`` shards on devices of the kind of
    ``device`` (``None`` → CUDA, raising when there is none): the first
    ``num_devices`` cards (default: all of them), raising for more than
    there are; on the CPU, ``num_devices`` shards (default 1) on the one
    host device. Raises ``ValueError`` for fewer than one."""
    dev = resolve_device(device)
    if num_devices is not None and num_devices < 1:
        raise ValueError(f"a serving mesh needs at least one shard, got "
                         f"{num_devices}")
    if dev.type == "cpu":
        return ServingMesh((dev,) * (num_devices or 1))
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if num_devices is not None:
        if num_devices > len(devs):
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


def installed_serving_mesh() -> Optional[ServingMesh]:
    """The mesh :func:`set_serving_mesh` installed, or ``None``."""
    return _SERVING


def get_serving_mesh(device=None) -> ServingMesh:
    """The installed serving mesh, else the degenerate one-device mesh on
    the kind of ``device`` (built once per kind: this sits on the
    per-micro-batch path). An installed mesh on another kind of device
    than an explicit ``device`` raises: nothing moves to the host or the
    card unasked."""
    if _SERVING is not None and device is None:
        return _SERVING
    kind = resolve_device(device).type
    if _SERVING is not None:
        if _SERVING.kind != kind:
            raise ValueError(f"the installed serving mesh is on "
                             f"{_SERVING.kind}; the caller asked for {kind}")
        return _SERVING
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



class serving_mesh:
    """with serving_mesh(make_serving_mesh(4, "cpu")): ... (restores the
    mesh installed before)."""

    def __init__(self, sm: ServingMesh):
        self.sm = sm

    def __enter__(self):
        self.prev = _SERVING
        set_serving_mesh(self.sm)
        return self.sm

    def __exit__(self, *exc):
        set_serving_mesh(self.prev)
        return False
