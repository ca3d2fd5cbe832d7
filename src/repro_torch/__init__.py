"""PyTorch / CUDA port of :mod:`repro` for NVIDIA Hopper (H100).

Same layout and names as ``src/repro/``; imports ``torch``, numpy and scipy
and nothing of JAX or of ``repro``. Ported so far: the served solve —
:class:`repro_torch.engine.SolverEngine` (train a selector, select on the
card: featurization through the ``csr_stats`` kernels and the classifier's
forward, with Table 2's nine orderings and Fig. 4's seven model families,
then :class:`repro_torch.core.plan.PlanBuilder`: reorder → permute →
symbolic, with a plan cache) and :func:`repro_torch.core.plan.execute_plan`
with the pipelined multifrontal factorization, device sweeps and fp64
refinement, on six hand-written CUDA kernels (:mod:`repro_torch.kernels`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
