"""The LM substrate's device mesh: named axes over a row-major grid of
devices, the port's counterpart of the ``jax.sharding.Mesh`` that the
reference's ``repro.distributed`` and ``repro.launch.mesh`` build.

The port has no SPMD compiler.  A sharded function splits each global
tensor into one local tensor per mesh coordinate
(`distributed.collectives.split`), runs its body shard after shard, and
joins the results (`collectives.join`); between body stages the
collectives take and return lists of per-shard tensors, in shard order.
Shard ``s`` sits at the row-major coordinate ``s`` of the grid and on
``mesh.devices[s]``.  A device may repeat: ``["cuda:0"] * 4`` or
``["cpu"] * 4`` runs four shards on one device, which is how the port's
sharded paths run where there is one card (or none); ``["meta"] * 256``
is the dry-run's production mesh (`launch.mesh.make_production_mesh`),
which holds no storage.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import visible_cards

Device = Union[str, torch.device]


class Mesh:
    """A mesh of ``shape`` (one size per axis) over ``devices``.

    ``mesh.shape`` is a dict keyed by axis name, in axis order, as the
    reference reads it (``mesh.shape["data"]``).  ``devices`` lists one
    device per coordinate, row-major (repeats allowed); by default the
    first ``prod(shape)`` CUDA cards, which raises without a card (or with
    too few: pass ``devices=`` to repeat one).
    """

    def __init__(self, shape: Sequence[int],
                 axis_names: Sequence[str] = ("data", "model"),
                 devices: Sequence[Device] = None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names):
            raise ValueError(f"mesh shape {shape} needs as many distinct "
                             f"axis names, got {axis_names}")
        if min(shape, default=0) < 1:
            raise ValueError(f"every mesh axis needs a size >= 1, got "
                             f"{shape}")
        n = math.prod(shape)
        if devices is None:
            cards = visible_cards()
            if cards < n:
                raise ValueError(f"a {shape} mesh needs {n} devices and "
                                 f"{cards} cards are visible; pass "
                                 f"devices= (a device may repeat)")
            devices = [torch.device("cuda", i) for i in range(n)]
        devs = tuple(resolve_device(d) for d in devices)
        if len(devs) != n:
            raise ValueError(f"a {shape} mesh needs {n} devices, got "
                             f"{len(devs)}")
        self.axis_names: Tuple[str, ...] = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.devices: Tuple[torch.device, ...] = devs
        self.size = n

    def coords(self, shard: int) -> Dict[str, int]:
        """The coordinate of shard ``shard`` on every axis (row-major)."""
        out = {}
        for a in reversed(self.axis_names):
            shard, out[a] = divmod(shard, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def __repr__(self) -> str:
        return (f"Mesh({tuple(self.shape.values())}, {self.axis_names}, "
                f"{[str(d) for d in self.devices]})")
