"""Explicit event representation (paper Fig. 1, §III-C).

Counterpart of ``repro.core.events``: a padded, time-sorted struct of
arrays with a static capacity and a validity mask.  Overflow past the
capacity is dropped and counted (the ASIC FIFO's back-pressure).  The
packed 32-bit memory word (:class:`EventFormat`, :func:`pack_events`)
is the reference's bit for bit; ``torch.uint32`` supports few
operations, so the words are built in int64 and masked to 32 bits.
"""
from __future__ import annotations

import dataclasses
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

    @property
    def capacity(self) -> int:
        """Static buffer size (valid slots + padding)."""
        return self.t.shape[0]

    def count(self) -> torch.Tensor:
        """Number of valid events in the buffer (an int32 tensor)."""
        return self.valid.sum(dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class EventFormat:
    """Bit allocation of the packed 32-bit event word (paper Fig. 1):
    DVS-Gesture (128x128, 2 polarities) with 2^12 timesteps by default."""

    op_bits: int = 2
    t_bits: int = 12
    c_bits: int = 4
    x_bits: int = 7
    y_bits: int = 7

    def __post_init__(self):
        total = (self.op_bits + self.t_bits + self.c_bits + self.x_bits
                 + self.y_bits)
        if total > 32:
            raise ValueError(f"event format needs {total} bits > 32")

    @property
    def shifts(self) -> Tuple[int, int, int, int, int]:
        """Bit offsets (op, t, c, x, y) of each packed field."""
        x_s = self.y_bits
        c_s = x_s + self.x_bits
        t_s = c_s + self.c_bits
        op_s = t_s + self.t_bits
        return op_s, t_s, c_s, x_s, 0


DEFAULT_FORMAT = EventFormat()


def _pack_fields(stream: EventStream, fmt: EventFormat):
    return (("op", stream.op, fmt.op_bits), ("t", stream.t, fmt.t_bits),
            ("c", stream.c, fmt.c_bits), ("x", stream.x, fmt.x_bits),
            ("y", stream.y, fmt.y_bits))


def pack_violations(stream: EventStream,
                    fmt: EventFormat = DEFAULT_FORMAT) -> torch.Tensor:
    """Count *valid* events whose fields do not fit the packed format
    (an int32 tensor on the stream's device; no host read)."""
    bad = torch.zeros_like(stream.valid)
    for _, arr, bits in _pack_fields(stream, fmt):
        bad = bad | (arr < 0) | (arr >= (1 << bits))
    return (bad & stream.valid).sum(dtype=torch.int32)


def pack_events(stream: EventStream, fmt: EventFormat = DEFAULT_FORMAT,
                check: bool = True) -> torch.Tensor:
    """Pack an EventStream into ``torch.uint32`` words (Fig. 1 format).

    ``unpack_events(pack_events(s), s.valid)`` reproduces every valid slot
    whose fields fit their bit budgets; padding slots are masked modulo
    the field widths.  ``check=True`` raises ``ValueError`` on a valid
    event whose field is out of range (a host read of the stream);
    ``check=False`` masks silently, as the hardware DMA does.
    """
    op_s, t_s, c_s, x_s, y_s = fmt.shifts
    if check:
        valid = stream.valid.cpu().numpy()
        for name, arr, bits in _pack_fields(stream, fmt):
            a = arr.cpu().numpy()[valid]
            if a.size and (a.min() < 0 or a.max() >= (1 << bits)):
                raise ValueError(
                    f"pack_events: field '{name}' of a valid event is out "
                    f"of range for {bits} bits (min={a.min()}, "
                    f"max={a.max()}); enlarge EventFormat.{name}_bits or "
                    f"pre-mask with check=False")

    def field(v, b, s):
        # int64, so the two's-complement bits of a negative field mask
        # as the reference's uint32 cast does
        return (v.to(torch.int64) & ((1 << b) - 1)) << s
    word = (field(stream.op, fmt.op_bits, op_s)
            | field(stream.t, fmt.t_bits, t_s)
            | field(stream.c, fmt.c_bits, c_s)
            | field(stream.x, fmt.x_bits, x_s)
            | field(stream.y, fmt.y_bits, y_s))
    return (word & 0xFFFFFFFF).to(torch.uint32)


def unpack_events(words: torch.Tensor, valid: torch.Tensor,
                  fmt: EventFormat = DEFAULT_FORMAT) -> EventStream:
    """Inverse of :func:`pack_events` (stream format decode in the DMA)."""
    op_s, t_s, c_s, x_s, y_s = fmt.shifts
    w = words.to(torch.int64) & 0xFFFFFFFF

    def take(s, b):
        return ((w >> s) & ((1 << b) - 1)).to(torch.int32)
    return EventStream(t=take(t_s, fmt.t_bits), x=take(x_s, fmt.x_bits),
                       y=take(y_s, fmt.y_bits), c=take(c_s, fmt.c_bits),
                       op=take(op_s, fmt.op_bits), valid=valid)


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


def concatenate_streams(a: EventStream, b: EventStream) -> EventStream:
    """Merge two streams and re-sort by timestep (the 'collector',
    §III-D3)."""
    return sort_stream(EventStream(*(torch.cat([fa, fb])
                                     for fa, fb in zip(a, b))))


def sort_stream(s: EventStream) -> EventStream:
    """Stable sort by (t, invalid-last); padding slots sort to the tail."""
    key = torch.where(s.valid, s.t, torch.iinfo(torch.int32).max)
    order = torch.argsort(key, stable=True)
    return EventStream(*(f[order] for f in s))


def activity(spikes: torch.Tensor) -> torch.Tensor:
    """Fraction of nonzero entries, float32 — the paper's 'firing
    activity' metric.  The reference's ``jnp.mean`` divides by a constant,
    which XLA compiles into a multiply by its float32 reciprocal; so does
    this, with the reciprocal a tensor quotient (exact on every device)."""
    one = torch.ones((), dtype=torch.float32, device=spikes.device)
    inv = one / torch.full_like(one, spikes.numel())
    return (spikes != 0).sum().to(torch.float32) * inv


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
