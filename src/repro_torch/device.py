"""Device choice for the port's entry points.

Replaces ``repro.kernels.ops._interpret`` (which ran the Pallas kernels in
interpret mode whenever JAX's backend was the CPU). The port runs on the
card unless the caller asks for the CPU: :func:`resolve_device` never falls
back silently.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "on_cuda", "to_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda`` (raises when there is no card); an explicit
    ``"cpu"`` selects the plain PyTorch versions of the kernels.

    Also turns TF32 off for matmuls and cuDNN, so float32 products on the
    card run in full float32 like the reference's f32 accumulation, and
    keeps the reductions of bfloat16 products in float32 (no split-K sums
    rounded to bfloat16), as XLA sums them.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on anything else
    or on a mix, so that a CUDA tensor never reaches a plain version."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
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
