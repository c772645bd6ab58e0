"""Explicit event representation (paper Fig. 1, §III-C).

Counterpart of ``repro.core.events``: a padded, time-sorted struct of
arrays with a static capacity and a validity mask.  Overflow past the
capacity is dropped and counted (the ASIC FIFO's back-pressure).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

OP_UPDATE = 0
OP_RST = 1
OP_FIRE = 2


class EventStream(NamedTuple):
    """A padded, time-sorted stream of events (struct of tensors).

    All tensors share shape ``(capacity,)``; padding slots have
    ``valid == False`` and ``t`` past the last real timestep.
    """

    t: torch.Tensor      # int32 — timestep of the event
    x: torch.Tensor      # int32 — vertical position (row)
    y: torch.Tensor      # int32 — horizontal position (column)
    c: torch.Tensor      # int32 — input channel
    op: torch.Tensor     # int32 — OP_UPDATE / OP_RST / OP_FIRE
    valid: torch.Tensor  # bool


def dense_to_events(spikes: torch.Tensor, capacity: int) -> EventStream:
    """Convert a dense ``(T, H, W, C)`` spike tensor to an EventStream.

    Events come out in row-major nonzero order (sorted by timestep); past
    ``capacity`` the overflow is dropped (see :func:`overflow_count`).
    """
    if spikes.dim() != 4:
        raise ValueError(f"expected (T,H,W,C), got {tuple(spikes.shape)}")
    nz = torch.nonzero(spikes != 0).to(torch.int32)[:capacity]   # (n, 4)
    n = nz.shape[0]
    dev = spikes.device
    t = torch.full((capacity,), spikes.shape[0], dtype=torch.int32,
                   device=dev)
    x = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    y = torch.zeros_like(x)
    c = torch.zeros_like(x)
    t[:n], x[:n], y[:n], c[:n] = nz[:, 0], nz[:, 1], nz[:, 2], nz[:, 3]
    return EventStream(
        t=t, x=x, y=y, c=c,
        op=torch.full((capacity,), OP_UPDATE, dtype=torch.int32, device=dev),
        valid=torch.arange(capacity, device=dev) < n)


def overflow_count(spikes: torch.Tensor, capacity: int) -> int:
    """Number of events that ``dense_to_events`` would drop."""
    return max(int((spikes != 0).sum()) - capacity, 0)


def capacity_for(shape: Tuple[int, int, int, int], act: float,
                 slack: float = 2.0, align: int = 128) -> int:
    """Pick a static event capacity for an expected activity level.

    ``slack`` over-provisions (like sizing the ASIC FIFOs); the result is
    rounded up to a multiple of ``align``.
    """
    n = int(shape[0] * shape[1] * shape[2] * shape[3] * act * slack)
    n = max(n, align)
    return ((n + align - 1) // align) * align


def events_to_dense(stream: EventStream, shape: Tuple[int, int, int, int],
                    binary: bool = True) -> torch.Tensor:
    """Scatter an EventStream back into a dense float32 ``(T, H, W, C)``
    tensor on the stream's device; padding and non-UPDATE slots add 0."""
    T, H, W, C = shape
    dense = torch.zeros(shape, dtype=torch.float32, device=stream.t.device)
    ones = (stream.valid & (stream.op == OP_UPDATE)).to(torch.float32)
    idx = tuple(torch.clamp(a, 0, n - 1).long() for a, n in
                zip((stream.t, stream.x, stream.y, stream.c), shape))
    dense.index_put_(idx, ones, accumulate=True)
    return torch.clamp(dense, max=1.0) if binary else dense
