"""Device choice for the port's entry points.

Replaces ``repro.kernels.ops._interpret`` (which ran the Pallas kernels in
interpret mode whenever JAX's backend was the CPU). The port runs on the
card unless the caller asks for the CPU: :func:`resolve_device` never falls
back silently.

The dry run (:mod:`repro_torch.launch.dryrun`) traces the card's code on
``meta`` tensors, which have shapes and dtypes and no storage. Inside
:class:`dry_run`, and only there, a meta tensor stands for a tensor on the
card: :func:`resolve_device` gives ``meta`` where a caller asks for the
card, and :func:`on_cuda` takes the card's branch for meta tensors (the
kernels' wrappers then apply their shape rule and launch nothing). Outside
it, a meta tensor is refused as before.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "on_cuda", "to_device", "dry_run",
           "in_dry_run", "CARD", "PEAK_BF16_FLOPS", "HBM_BYTES_PER_S",
           "NVLINK_BYTES_PER_S", "HBM_BYTES"]

# The card the port is written for, as ``nvidia-smi --query-gpu=name,
# power.limit --format=csv,noheader`` prints it; the rates are the data
# sheet's (SXM part, dense) at that power limit. The dry run's roofline and
# the plan selector's capacity read them.
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
#: bf16 dense tensor-core peak (FLOP/s)
PEAK_BF16_FLOPS = 989e12
#: device-memory bandwidth (bytes/s)
HBM_BYTES_PER_S = 3.35e12
#: NVLink 4 bandwidth, one direction (bytes/s). A 16 × 16 mesh of H100s
#: spans 32 nodes of eight cards, and the links between nodes are slower
#: than NVLink, so a collective term over this rate is a lower bound
NVLINK_BYTES_PER_S = 4.5e11
#: device memory, as ``torch.cuda.get_device_properties(0).total_memory``
#: reports it on that card
HBM_BYTES = 85_017_493_504

#: how many :class:`dry_run` contexts are open (process-wide: autograd runs
#: a backward's device work on threads of its own)
_DRY_RUNS = 0


class dry_run:
    """``with dry_run(): ...`` traces on meta tensors as if on the card.
    Nothing is allocated on any device inside it."""

    def __enter__(self) -> torch.device:
        global _DRY_RUNS
        _DRY_RUNS += 1
        return torch.device("meta")

    def __exit__(self, *exc) -> bool:
        global _DRY_RUNS
        _DRY_RUNS -= 1
        return False


def in_dry_run() -> bool:
    """Whether a :class:`dry_run` is open."""
    return _DRY_RUNS > 0


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda`` (raises when there is no card); an explicit
    ``"cpu"`` selects the plain PyTorch versions of the kernels.

    Also turns TF32 off for matmuls and cuDNN, so float32 products on the
    card run in full float32 like the reference's f32 accumulation, and
    keeps the reductions of bfloat16 products in float32 (no split-K sums
    rounded to bfloat16), as XLA sums them.

    Inside :class:`dry_run`, the card (``None`` or ``"cuda"``) resolves to
    ``meta``, with or without a card present.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda" if device is None else device)
    if in_dry_run() and dev.type in ("cuda", "meta"):
        return torch.device("meta")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on anything else
    or on a mix, so that a CUDA tensor never reaches a plain version. Inside
    :class:`dry_run`, True for meta tensors too."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"} or (types == {"meta"} and in_dry_run()):
        return True
    if types == {"cpu"}:
        return False
    raise ValueError(f"tensors must all be on CUDA or all on the CPU, got "
                     f"{sorted(types)}")


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → tensor on ``device``. For CUDA the array is staged in
    pinned memory and copied asynchronously, so the host does not wait for
    the work already queued on the stream."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
