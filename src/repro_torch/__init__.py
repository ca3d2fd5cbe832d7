"""PyTorch / CUDA port of :mod:`repro` for NVIDIA Hopper (H100).

Same layout and names as ``src/repro/``; imports ``torch``, numpy and scipy
and nothing of JAX or of ``repro``. Ported so far: the numeric half of a
served solve — :class:`repro_torch.core.plan.PlanBuilder` (reorder → permute
→ symbolic) and :func:`repro_torch.core.plan.execute_plan` with the
pipelined multifrontal factorization, device sweeps and fp64 refinement on
four hand-written CUDA kernels (:mod:`repro_torch.kernels`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
