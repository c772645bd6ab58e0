"""Architecture registry (counterpart of ``repro.configs``).

``get_config(name)`` returns the full published configuration and
``get_smoke(name)`` a reduced same-family config for CPU tests.  The
registry names all ten assigned architectures; the port serves the five
built only from the layer kinds it has (global and local attention,
RG-LRU, dense FFN).  The other five raise ``NotImplementedError`` naming
the ROADMAP item (Queue A, the LM substrate) that ports what they need.
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
    "recurrentgemma-2b": "recurrentgemma_2b",
}

_NOT_PORTED = {
    "whisper-medium": "the encoder and frontend.py (ROADMAP Queue A, "
                      "LM substrate item 4)",
    "llama4-maverick-400b-a17b": "moe.py (ROADMAP Queue A, LM substrate "
                                 "item 2)",
    "olmoe-1b-7b": "moe.py (ROADMAP Queue A, LM substrate item 2)",
    "internvl2-26b": "the encoder and frontend.py (ROADMAP Queue A, LM "
                     "substrate item 4)",
    "xlstm-1.3b": "xlstm.py (ROADMAP Queue A, LM substrate item 3)",
}


def _load(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(f"{name} needs {_NOT_PORTED[name]}, not "
                                  f"ported yet")
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
