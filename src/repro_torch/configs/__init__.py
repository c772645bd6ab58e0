"""Architecture registry (counterpart of ``repro.configs``).

``get_config(name)`` returns the full published configuration and
``get_smoke(name)`` a reduced same-family config for CPU tests, for all
ten assigned architectures (pure-Python copies of ``repro.configs``).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "granite-8b",
    "gemma3-1b",
    "deepseek-7b",
    "glm4-9b",
    "whisper-medium",
    "llama4-maverick-400b-a17b",
    "olmoe-1b-7b",
    "internvl2-26b",
    "recurrentgemma-2b",
    "xlstm-1.3b",
)

_MODULES = {
    "granite-8b": "granite_8b",
    "gemma3-1b": "gemma3_1b",
    "deepseek-7b": "deepseek_7b",
    "glm4-9b": "glm4_9b",
    "whisper-medium": "whisper_medium",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "internvl2-26b": "internvl2_26b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-1.3b": "xlstm_1_3b",
}


def _load(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    cfg = _load(name).config()
    cfg.validate()
    return cfg


def get_smoke(name: str) -> ModelConfig:
    cfg = _load(name).smoke()
    cfg.validate()
    return cfg
