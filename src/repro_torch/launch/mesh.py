"""Mesh construction for the launchers, counterpart of
``repro.launch.mesh``: a function, so importing it touches no device.

The reference's ``make_production_mesh`` (a 16 x 16 or 2 x 16 x 16 TPU
mesh) belongs to the dry-run, which is not ported.
"""
from __future__ import annotations

from repro_torch.distributed.mesh import Mesh


def make_host_mesh(device=None) -> Mesh:
    """The single-device mesh (1 x 1, axes ``("data", "model")``) on
    ``device`` (default: the CUDA device, raising without one)."""
    return Mesh((1, 1), ("data", "model"),
                [device if device is not None else "cuda"])
