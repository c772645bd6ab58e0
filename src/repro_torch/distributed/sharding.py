"""Slot-axis placement for the mesh serving backend.

Counterpart of the slot-axis helpers of ``repro.distributed.sharding``.
The reference builds a 1-D JAX mesh over the slot axis and runs one
``shard_map``-ped step over it; the port has no such collective, so its
"mesh" is the ordered tuple of devices that hold the slot shards, shard
``s`` owning global slots ``[s * n / D, (s + 1) * n / D)``.  A device may
repeat: ``["cpu", "cpu"]`` or ``["cuda:0", "cuda:0"]`` puts several
shards on one device, which exercises the router and both dispatch paths
where only one device exists.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from repro_torch.device import resolve_device

Devices = Union[None, int, Sequence[Union[str, torch.device]]]


def visible_cards() -> int:
    """The number of CUDA cards this process sees; raise without one (as
    every entry point of the port does)."""
    resolve_device("cuda")
    return torch.cuda.device_count()


def slot_mesh(devices: Devices = None) -> Tuple[torch.device, ...]:
    """The devices of the slot shards, in shard order.

    ``devices`` is a sequence of devices (repeats allowed), a count (the
    first ``n`` visible cards), or None for every visible card.  Each
    device is resolved by `repro_torch.device.resolve_device`, so asking
    for CUDA on a machine without a card raises.
    """
    if devices is None:
        devices = visible_cards()
    if isinstance(devices, int):
        if devices < 1:
            raise ValueError(f"need at least 1 device, got {devices}")
        n = visible_cards()
        if devices > n:
            raise ValueError(f"requested {devices} devices, only {n} "
                             f"visible")
        return tuple(torch.device("cuda", i) for i in range(devices))
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("need at least 1 device, got an empty sequence")
    return devs


def shard_count(n_slots: int, n_visible: int) -> int:
    """The auto-pick rule of ``devices=None``: the largest divisor of
    ``n_slots`` that is at most ``min(n_visible, n_slots)``, so that the
    slots divide into equal shards whatever the slot count."""
    if n_slots < 1 or n_visible < 1:
        raise ValueError(f"need n_slots >= 1 and n_visible >= 1, got "
                         f"{n_slots} and {n_visible}")
    d = min(n_visible, n_slots)
    while n_slots % d:
        d -= 1
    return d
