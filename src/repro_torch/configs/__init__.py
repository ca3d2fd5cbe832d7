"""Port of ``repro/configs``: the architecture registry, one module per
assigned architecture, copied with the port's :class:`ModelConfig`.

``get_config(name)`` returns the full (paper-exact) config;
``get_smoke_config(name)`` returns a reduced same-family config for CPU
smoke tests (small dims, few layers/experts, tiny vocab).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_MODULES: Dict[str, str] = {
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b_a6_6b",
    "xlstm-125m": "xlstm_125m",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "starcoder2-7b": "starcoder2_7b",
    "qwen3-1.7b": "qwen3_1_7b",
    "llama3.2-1b": "llama32_1b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "musicgen-large": "musicgen_large",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}

ARCH_NAMES: List[str] = list(ARCH_MODULES)


def _module(name: str):
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()
