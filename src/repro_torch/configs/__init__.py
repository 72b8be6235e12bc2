"""Architecture registry: ``get_config(arch_id)`` / ``--arch <id>``.

The reference's ids and canonical names. Each module defines CONFIG (the
published dimensions), REDUCED (same family, tiny dimensions) for CPU
tests and ``LONG_CONTEXT_OK`` (a sub-quadratic long-context path: ssm,
hybrid, swa or local_global; the long_500k shape is skipped elsewhere),
copied from the reference.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "gemma2_2b",
    "granite_34b",
    "h2o_danube_1_8b",
    "codeqwen1_5_7b",
    "mamba2_130m",
    "qwen2_vl_7b",
    "granite_moe_3b_a800m",
    "phi3_5_moe_42b_a6_6b",
    "musicgen_large",
    "zamba2_2_7b",
]

# canonical ids as listed in the assignment (dashes/dots)
CANONICAL = {
    "gemma2-2b": "gemma2_2b",
    "granite-34b": "granite_34b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "mamba2-130m": "mamba2_130m",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b_a6_6b",
    "musicgen-large": "musicgen_large",
    "zamba2-2.7b": "zamba2_2_7b",
}


def _norm(arch: str) -> str:
    return CANONICAL.get(arch, arch.replace("-", "_").replace(".", "_"))


def _module(arch: str):
    name = _norm(arch)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    return _module(arch).REDUCED


def long_context_ok(arch: str) -> bool:
    return _module(arch).LONG_CONTEXT_OK


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
