"""Architecture registry (counterpart of ``repro.configs``).

``get_config(name)`` returns the full published configuration and
``get_smoke(name)`` a reduced same-family config for CPU tests, for all
ten assigned architectures (pure-Python copies of ``repro.configs``).
``SHAPES`` lists the assigned input shapes; ``cell_supported`` encodes the
documented skip (long_500k for pure full-attention archs); the paper's own
eCNN is ``configs.sne_dvsgesture``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

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


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Sub-quadratic archs run long_500k; pure full-attention archs skip it.
LONG_CONTEXT_OK = {"gemma3-1b", "recurrentgemma-2b", "xlstm-1.3b"}


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


def cell_supported(arch: str, shape: str) -> Tuple[bool, Optional[str]]:
    """(supported, reason-if-not) for one (arch x shape) cell."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False, ("pure full-attention arch: 512k-token full-attention "
                       "KV is out of assignment scope (DESIGN.md §5)")
    return True, None


def all_cells():
    """``(arch, shape, supported, reason)`` for every (arch x shape)."""
    for arch in ARCH_IDS:
        for shape in SHAPES:
            ok, why = cell_supported(arch, shape)
            yield arch, shape, ok, why
