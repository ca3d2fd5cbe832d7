"""Port of ``repro/launch/mesh.py``: ``make_production_mesh`` (:19) and
``mesh_axes`` (:25), with the port's own :func:`make_mesh`, which both the
training launcher and the tests build their meshes with, and the rank
plumbing around it (:func:`init_ranks`, :func:`run_ranks`).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names over the running process group. :func:`make_mesh`
makes every group it needs itself, each with a timeout: one group per axis
(the mesh's own dimension groups) and one per set of two or more axes (the
data axes of a multi-pod mesh, the whole mesh under ``pure_dp``), which it
registers with :mod:`repro_torch.distributed.meshctx`. Every rank must call
it, in the same order, as with any group creation.

CUDA tensors go over NCCL and CPU tensors over gloo, with one card a rank:
:func:`init_ranks` picks the backend from the device and never falls back.
The dry run (:mod:`repro_torch.launch.dryrun`) builds its meshes over
:func:`fake_ranks`: ``torch.distributed``'s ``fake`` backend, with this
process as rank 0 of 256 or 512 ranks that do not exist. Its collectives
return at once and move nothing; :func:`make_mesh` admits that group only
inside :class:`repro_torch.device.dry_run`, where the mesh is one of
``meta`` tensors.

Single pod: 16 × 16 = 256 ranks, axes (data, model). Multi-pod: 2 × 16 × 16
= 512 ranks, axes (pod, data, model); 'pod' extends the data-parallel
dimension, and batches shard over ('pod', 'data').
"""
from __future__ import annotations

import contextlib
import datetime
import itertools
import os
import time
from typing import Callable, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..distributed.meshctx import register_groups

__all__ = ["make_production_mesh", "mesh_axes", "make_mesh", "init_ranks",
           "run_ranks", "fake_ranks", "TIMEOUT_S"]

#: the timeout of every process group and collective (seconds)
TIMEOUT_S = 120.0
_TIMEOUT = datetime.timedelta(seconds=TIMEOUT_S)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    default process group (row-major: rank = coordinates over ``shape``).
    Raises ``ValueError`` unless the world has ``prod(shape)`` ranks, and
    ``RuntimeError`` when the group's backend does not fit ``device``
    (NCCL for CUDA, gloo for the CPU, the fake backend for a dry run's
    card)."""
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
    dev = resolve_device(device)
    world = dist.get_world_size()
    if int(torch.tensor(shape).prod()) != world:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{int(torch.tensor(shape).prod())} ranks; the "
                         f"world has {world}")
    _check_backend(dist.group.WORLD, dev)
    rank = dist.get_rank()
    grid = torch.arange(world).view(shape)
    groups = {}
    for k in range(1, len(axes) + 1):
        for dims in itertools.combinations(range(len(axes)), k):
            # every coset of these dims, in one order on every rank
            rest = [d for d in range(len(axes)) if d not in dims]
            cosets = grid.permute(rest + list(dims)).reshape(
                -1, int(torch.tensor([shape[d] for d in dims]).prod()))
            for ranks in cosets.tolist():
                g = dist.new_group(ranks, timeout=_TIMEOUT)
                if rank in ranks:
                    groups[tuple(axes[d] for d in dims)] = g
    mesh = DeviceMesh.from_group([groups[(a,)] for a in axes], dev.type,
                                 mesh=grid, mesh_dim_names=axes)
    register_groups(mesh, groups)
    return mesh


def _check_backend(group, dev: torch.device) -> None:
    backend = dist.get_backend(group)
    # a meta device only comes out of resolve_device inside a dry run
    want = {"cuda": "nccl", "cpu": "gloo", "meta": "fake"}[dev.type]
    if backend != want:
        raise RuntimeError(f"a mesh over {dev.type} tensors runs {want}; "
                           f"the process group runs {backend}")


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The 16 × 16 (data, model) mesh, or 2 × 16 × 16 (pod, data, model)
    with ``multi_pod``, over the running process group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def mesh_axes(multi_pod: bool = False) -> Tuple[Tuple[str, ...], str]:
    """(data_axes, model_axis) for a production mesh."""
    return (("pod", "data") if multi_pod else ("data",)), "model"


@contextlib.contextmanager
def fake_ranks(world: int):
    """``with fake_ranks(256): ...`` runs the block as rank 0 of a default
    process group of ``world`` ranks on the ``fake`` backend (a dry run's:
    no other rank exists and no collective moves data), destroyed on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def init_ranks(rank: int, world: int, store_path: str,
               device=None) -> torch.device:
    """Join the default process group as ``rank`` of ``world`` through a
    file store at ``store_path``: NCCL with card ``rank`` for ``cuda``
    (raising when there are fewer cards than ranks), gloo for ``cpu``.
    Returns the rank's device."""
    dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        if world > torch.cuda.device_count():
            raise RuntimeError(f"{world} ranks need {world} CUDA devices; "
                               f"there are {torch.cuda.device_count()}")
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world,
                            timeout=_TIMEOUT, **kw)
    return dev


def _rank_main(rank: int, fn, world: int, store_path: str, device,
               args) -> None:
    torch.set_num_threads(1)
    init_ranks(rank, world, store_path, device)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, store_dir: str, args: tuple = (),
              device=None, timeout: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes, each in the
    process group (one thread each; a file store under ``store_dir``), and
    join them within ``timeout`` seconds. A rank that raises fails the run
    (``torch.multiprocessing.ProcessRaisedException``); at the timeout the
    ranks are killed and ``TimeoutError`` is raised. ``fn`` must be
    importable by name (a module-level function)."""
    import torch.multiprocessing as mp

    os.makedirs(store_dir, exist_ok=True)
    store = os.path.join(store_dir, f"store_{os.getpid()}_{time.time_ns()}")
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, store, device, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, min(
                5.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish within "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
