"""Architecture registry: ``--arch <id>`` resolves here."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

__all__ = ["ARCH_IDS", "get_config", "all_configs"]

_MODULES = {
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "gemma2-9b": "repro_torch.configs.gemma2_9b",
    "qwen1.5-32b": "repro_torch.configs.qwen1_5_32b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
