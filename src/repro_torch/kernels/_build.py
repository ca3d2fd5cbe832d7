"""Build and load the port's CUDA kernels (``csrc/``) at first use.

One ``torch.utils.cpp_extension.load`` call compiles every source in
``csrc/`` for ``sm_90a`` (Hopper) into ``build/torch_kernels/`` at the root
of the checkout, which ``.gitignore`` lists, and registers the ops as
``torch.ops.repro_torch.*``. Only ``bindings.cpp`` includes PyTorch headers;
the ``.cu`` files are plain CUDA, so the build takes seconds for them and
the binding dominates. Nothing is built at import time: the CPU tests import
every module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import functools
import os
import pathlib

__all__ = ["load_kernels"]

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("bindings.cpp", "frontal_factor.cu", "extend_add.cu",
           "tri_solve.cu", "spmv_bell.cu", "csr_stats.cu", "tile_kernels.cu",
           "flash_attention.cu", "flash_attention_sm90.cu")


@functools.cache
def load_kernels():
    """Compile (or reuse the build in ``BUILD_DIR``) and return the
    ``torch.ops.repro_torch`` namespace. Raises if the build fails."""
    import torch
    from torch.utils.cpp_extension import load

    os.makedirs(BUILD_DIR, exist_ok=True)
    load(name="repro_torch_kernels",
         sources=[str(_CSRC / s) for s in SOURCES],
         build_directory=str(BUILD_DIR),
         extra_include_paths=[str(_CSRC)],
         extra_cflags=["-O3"],
         extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"],
         is_python_module=False)
    return torch.ops.repro_torch
