"""Port of ``repro/engine/config.py``: :class:`EngineConfig`, one dataclass
for the whole stack.

The fields and their validation are the reference's, plus ``device`` and
less ``use_pallas``: the port's device featurizer always runs the
``csr_stats`` kernels on the card, so there is no switch to the plain
reductions there. The defaults are the served main path of the port: device featurization through
the ``csr_stats`` kernels, forest inference on the card, the pipelined
factor, device sweeps and fp64 refinement, and an in-memory plan cache.
Every ``backend``, ``sweep`` and ``solver`` of the reference is accepted, and
so are the serving fields: the disk tier of the plan cache
(``cache_dir`` and its budgets), the dispatcher (``max_wait_ms``,
``build_workers``, ``max_queue``, ``default_deadline_ms``), the metrics
sink (``metrics_jsonl``) and the RPC bind address (``rpc_host``,
``rpc_port``); the solve tuner's (``autotune_solve``, ``autotune_dir``) and
the bundle lifecycle's (``bundle_dir``, the ``promote_*`` thresholds,
``shadow_max_queue``).

Three defaults differ from the reference's. ``cache_dir`` is ``None`` (the
plan cache stays in memory) where the reference's is its
``artifacts/plan_cache``, so an engine writes into its working directory
only when asked; the port's own directory is
:data:`repro_torch.core.plan_cache.DEFAULT_CACHE_DIR`
(``artifacts/plan_cache_torch``), which the launchers default to.
``autotune_dir`` is ``artifacts/autotune_torch`` and ``bundle_dir``
``artifacts/bundles_torch``, the port's own directories, so that a policy
or bundle registry written by the reference is never read as the port's.

``serving_devices`` is the width of the serving mesh the engine installs
(:func:`repro_torch.distributed.meshctx.make_serving_mesh`): that many
cards, raising when the machine has fewer, or that many shards on the host
with ``device="cpu"``. A width below one raises ``ValueError``. Nothing
falls back to fewer shards.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional, Sequence

__all__ = ["EngineConfig"]


@dataclasses.dataclass
class EngineConfig:
    """Everything a :class:`SolverEngine` composes, in one place.

    Capability fields (``model``, ``scaling``, ``feature_set``,
    ``algorithms``) are *registry names*, so swapping any of them is a
    config edit, not a code edit.
    """

    # capability selection (registry names)
    model: str = "random_forest"
    scaling: str = "standard"
    feature_set: str = "paper12"
    # None → adopt the label set of the training dataset / loaded bundle;
    # set it to *assert* the labels (train() rejects a dataset whose
    # algorithm list disagrees)
    algorithms: Optional[Sequence[str]] = None

    # plan cache: dir=None/"" keeps it in memory (the port's default; the
    # reference's is its disk dir); byte/entry budgets bound the disk tier
    # (LRU-by-mtime eviction)
    cache_dir: Optional[str] = None
    cache_capacity: int = 4096
    cache_max_disk_bytes: Optional[int] = None
    cache_max_disk_entries: Optional[int] = None

    # featurization / inference path
    path: str = "device"          # "device" (padded CSR batch) or "host"
    batch_size: int = 16
    # serving-mesh width: None leaves the installed mesh (one device by
    # default); N splits each served batch over N cards (N shards on the
    # host with device="cpu")
    serving_devices: Optional[int] = None
    # where the device path and the solve run: None → CUDA (raising when
    # there is no card); "cpu" runs the kernels' plain versions
    device: Optional[str] = None

    # async serving: the dispatcher's micro-batch wait and build pool;
    # max_queue=None keeps the dispatch queue unbounded, else submit raises
    # QueueFull at it; default_deadline_ms stamps a deadline on requests
    # that arrive without one (expired ones are shed with DeadlineExceeded)
    max_wait_ms: float = 5.0
    build_workers: int = 2
    max_queue: Optional[int] = None
    default_deadline_ms: Optional[float] = None
    # structured metrics: a path here also streams events as JSON lines
    metrics_jsonl: Optional[str] = None
    # RPC front-end (SolverEngine.serve(rpc=True)); port 0 binds an
    # ephemeral port, published on the returned server
    rpc_host: str = "127.0.0.1"
    rpc_port: int = 0

    # numeric solve (see repro_torch.core.plan.execute_plan)
    solver: str = "multifrontal"
    backend: str = "pipelined"
    solve_dtype: str = "fp32_refine"
    sweep: str = "device"
    # the solve tuner (repro_torch.autotune.solve_tuner): True tunes on a
    # miss and persists the winner; a valid persisted policy for this
    # device kind and backend is applied either way
    autotune_solve: bool = False
    autotune_dir: str = os.path.join("artifacts", "autotune_torch")

    # training
    fast_grids: bool = False
    cv: int = 5
    test_size: float = 0.2
    seed: int = 0

    # bundle lifecycle (repro_torch.lifecycle): the registry promote() and
    # rollback() swap, the default promotion gate, the shadow mirror queue
    bundle_dir: str = os.path.join("artifacts", "bundles_torch")
    promote_min_accuracy: float = 0.5
    promote_min_shadow_requests: int = 10
    promote_min_win_rate: float = 0.5
    shadow_max_queue: int = 512

    def __post_init__(self) -> None:
        if self.path not in ("host", "device"):
            raise ValueError(f"path must be 'host' or 'device', "
                             f"got {self.path!r}")
        if self.backend not in ("numpy", "pallas", "batched", "pipelined"):
            raise ValueError(f"backend must be 'numpy', 'pallas', 'batched' "
                             f"or 'pipelined', got {self.backend!r}")
        if self.solve_dtype not in ("fp64", "fp32", "fp32_refine"):
            raise ValueError(f"solve_dtype must be 'fp64', 'fp32' or "
                             f"'fp32_refine', got {self.solve_dtype!r}")
        if self.sweep not in ("auto", "seq", "level", "device"):
            raise ValueError(f"sweep must be 'auto', 'seq', 'level' or "
                             f"'device', got {self.sweep!r}")
        if self.device not in (None, "cuda", "cpu"):
            raise ValueError(f"device must be None, 'cuda' or 'cpu', got "
                             f"{self.device!r}")
        if self.solver not in ("multifrontal", "simplicial"):
            raise ValueError(f"solver must be 'multifrontal' or "
                             f"'simplicial', got {self.solver!r}")
        if self.serving_devices is not None and self.serving_devices < 1:
            raise ValueError(f"serving_devices must be None or at least 1, "
                             f"got {self.serving_devices!r}")
        if (self.solve_dtype == "fp64"
                and (self.backend in ("pallas", "batched", "pipelined")
                     or self.sweep == "device")):
            what = (f"backend {self.backend!r} factors"
                    if self.backend != "numpy" or self.sweep != "device"
                    else "sweep 'device' solves")
            warnings.warn(
                f"{what} in fp32; solve_dtype "
                f"'fp64' will run as 'fp32_refine' (fp32 factorization + "
                f"fp64 iterative refinement). Set solve_dtype="
                f"'fp32_refine' explicitly to silence this.",
                UserWarning, stacklevel=2)
