"""Assigned-architecture registry: ``get_config("<arch-id>")``."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "h2o-danube-3-4b",
    "yi-9b",
    "llama3_2-1b",
    "mistral-large-123b",
    "mixtral-8x7b",
    "qwen3-moe-235b-a22b",
    "zamba2-2_7b",
    "chameleon-34b",
    "mamba2-370m",
    "seamless-m4t-medium",
]

_ALIASES = {
    "llama3.2-1b": "llama3_2-1b",
    "zamba2-2.7b": "zamba2-2_7b",
}


def get_config(arch_id: str) -> ModelConfig:
    arch_id = _ALIASES.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id.replace('-', '_')}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
