"""Device selection shared by every entry point of the port.

The port's entry points (`core.layer_program.compile_program`,
`serve.event_engine.EventServeEngine`, the weight loaders) run on the CUDA
device by default.  Nothing falls back to the CPU quietly: without a card
the default raises, and a caller that wants the CPU (the tests, the plain
reference path) says so with ``device="cpu"``.
"""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """Return ``device`` as a ``torch.device`` with its index resolved
    (``"cuda"`` becomes the current card); raise if CUDA is asked for but
    absent.  ``None`` means the default, ``"cuda"``."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine; the port runs on "
                "the GPU by default — pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
