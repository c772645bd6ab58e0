"""Mesh construction for the launchers and the dry-run, counterpart of
``repro.launch.mesh``: functions, so importing this module touches no
device.
"""
from __future__ import annotations

from repro_torch.distributed.mesh import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh over ``meta`` devices: 16 x 16 = 256 chips a
    pod (axes ``("data", "model")``); ``multi_pod`` adds the leading
    2-pod axis (``("pod", "data", "model")``, 512 devices).  The dry-run
    (`launch.dryrun`) runs a cell's step on it without a byte of storage,
    as the reference lowers onto placeholder devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    return Mesh(shape, axes, ["meta"] * n)


def make_host_mesh(device=None) -> Mesh:
    """The single-device mesh (1 x 1, axes ``("data", "model")``) on
    ``device`` (default: the CUDA device, raising without one)."""
    return Mesh((1, 1), ("data", "model"),
                [device if device is not None else "cuda"])
