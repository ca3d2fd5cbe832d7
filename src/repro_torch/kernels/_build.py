"""Build and load the port's CUDA kernels (``csrc/``) at first use.

One ``torch.utils.cpp_extension.load`` call compiles every source in
``csrc/`` for ``sm_90a`` (Hopper) into ``build/torch_kernels/`` at the root
of the checkout, which ``.gitignore`` lists, and registers the ops as
``torch.ops.repro_torch.*``. Only ``bindings.cpp`` includes PyTorch headers;
the ``.cu`` files are plain CUDA, so the build takes seconds for them and
the binding dominates. Nothing is built at import time: the CPU tests import
every module on a machine with no ``nvcc``.

Both helpers here are safe to call from several threads at once, as the
serving plane does (its batcher, build workers and RPC connection threads):
:func:`load_kernels` builds once however many first calls race, and
:func:`count_launch` is the one place a wrapper adds to its ``launches``.

:func:`note_work` is where a wrapper tells the operation count
(:mod:`repro_torch.launch.op_analysis`) what one call computes, the same
whether the kernel ran or a dry run applied the wrapper's shape rule; it
counts no launch.
"""
from __future__ import annotations

import os
import pathlib
import threading

__all__ = ["load_kernels", "count_launch", "reset_launches", "note_work",
           "WORK_SINKS"]

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("bindings.cpp", "frontal_factor.cu", "extend_add.cu",
           "tri_solve.cu", "spmv_bell.cu", "csr_stats.cu", "tile_kernels.cu",
           "flash_attention.cu", "flash_attention_sm90.cu",
           "flash_attention_bwd.cu", "flash_attention_bwd_sm90.cu")


_BUILD_LOCK = threading.Lock()
_OPS = None
_COUNT_LOCK = threading.Lock()


def load_kernels():
    """Compile (or reuse the build in ``BUILD_DIR``) and return the
    ``torch.ops.repro_torch`` namespace, once per process: a second caller
    waits for the first's build. Raises if the build fails (and a later
    call tries again)."""
    global _OPS
    if _OPS is not None:
        return _OPS
    with _BUILD_LOCK:
        if _OPS is None:
            import torch
            from torch.utils.cpp_extension import load

            os.makedirs(BUILD_DIR, exist_ok=True)
            load(name="repro_torch_kernels",
                 sources=[str(_CSRC / s) for s in SOURCES],
                 build_directory=str(BUILD_DIR),
                 extra_include_paths=[str(_CSRC)],
                 extra_cflags=["-O3"],
                 extra_cuda_cflags=["-O3",
                                    "-gencode=arch=compute_90a,code=sm_90a"],
                 is_python_module=False)
            _OPS = torch.ops.repro_torch
    return _OPS


def count_launch(wrapper, n: int = 1) -> None:
    """Add ``n`` to ``wrapper.launches`` under a lock: ``+=`` on an
    attribute is a read-modify-write that two threads can interleave."""
    with _COUNT_LOCK:
        wrapper.launches += n


def reset_launches(wrappers) -> None:
    """Set ``launches`` of every wrapper to 0 under the same lock."""
    with _COUNT_LOCK:
        for fn in wrappers:
            fn.launches = 0


#: callables ``sink(name, flops, nbytes)`` that :func:`note_work` calls
#: (an operation count adds itself while it counts)
WORK_SINKS: list = []


def note_work(name: str, flops: float, nbytes: float) -> None:
    """Tell every sink in :data:`WORK_SINKS` that one call of the kernel
    ``name`` does ``flops`` operations on ``nbytes`` of operands and
    results."""
    for sink in tuple(WORK_SINKS):
        sink(name, flops, nbytes)
