"""Admission layer: bounded queueing, SLO deadlines, slot policies
(counterpart of ``repro.serve.runtime.admission``).

The streaming runtime separates *arrival* from *admission*: an open-loop
load source delivers :class:`StreamRequest`s at their arrival times
regardless of server state (that is what "open-loop" means — the sensor
does not slow down because the server is busy), and this layer decides
what happens next:

  * the bounded :class:`AdmissionQueue` absorbs bursts; when it is full
    the request is **rejected gracefully** (counted, never served) —
    overload sheds load instead of growing an unbounded backlog;
  * every request may carry an absolute SLO ``deadline_s``; requests
    that expire while queued are dropped (*expired*), and requests whose
    deadline passes mid-service are **evicted** from their slot by the
    runtime (the slot is reclaimed for work that can still meet its SLO);
  * when a slot frees, :func:`choose_slot` picks where the queue head
    goes — FIFO (lowest free slot) or least-loaded (the free slot with
    the least cumulative served work; the single-device precursor of the
    multi-shard router).

Request lifecycle: ``queued -> running -> done``, with the three
terminal SLO outcomes ``rejected`` (queue full), ``expired`` (deadline
passed in queue) and ``evicted`` (deadline passed in a slot).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np

from repro_torch.serve.event_engine import EventRequest

# lifecycle states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
REJECTED = "rejected"    # bounded queue was full at arrival
EXPIRED = "expired"      # deadline passed while still queued
EVICTED = "evicted"      # deadline passed mid-service; slot reclaimed

# slot-selection policies
SLOT_FIFO = "fifo"
SLOT_LEAST_LOADED = "least-loaded"
SLOT_POLICIES = (SLOT_FIFO, SLOT_LEAST_LOADED)


@dataclasses.dataclass
class StreamRequest:
    """One request's journey through the streaming runtime.

    Wraps the engine's :class:`~repro_torch.serve.event_engine.EventRequest`
    (the compute payload) with everything the admission layer and the
    telemetry need: arrival time, absolute SLO deadline, lifecycle
    status, and the per-window latency samples recorded while running.
    """

    req: EventRequest
    arrival_s: float
    deadline_s: Optional[float] = None   # absolute clock time, or no SLO
    status: str = QUEUED
    slot: Optional[int] = None
    admit_s: Optional[float] = None
    finish_s: Optional[float] = None     # set on done/evicted/expired
    window_latencies_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def uid(self) -> int:
        """The wrapped request's uid (stable across the pipeline)."""
        return self.req.uid

    @property
    def queue_wait_s(self) -> Optional[float]:
        """Arrival -> admission wait, or None if never admitted."""
        if self.admit_s is None:
            return None
        return self.admit_s - self.arrival_s

    @property
    def e2e_latency_s(self) -> Optional[float]:
        """Arrival -> completion latency, or None if not completed."""
        if self.finish_s is None or self.status != DONE:
            return None
        return self.finish_s - self.arrival_s


class AdmissionQueue:
    """Bounded FIFO of stream requests — the overload backstop.

    ``offer`` rejects (and marks) a request when the queue is full;
    ``expire`` drops queued requests whose deadline has already passed,
    so a slot is never spent on work that cannot meet its SLO.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("queue capacity must be >= 1")
        self.capacity = capacity
        self._q: deque = deque()

    def __len__(self) -> int:
        return len(self._q)

    def offer(self, sreq: StreamRequest, now: float) -> bool:
        """Enqueue, or reject gracefully when full (status ``rejected``)."""
        if len(self._q) >= self.capacity:
            sreq.status = REJECTED
            sreq.finish_s = now
            return False
        sreq.status = QUEUED
        self._q.append(sreq)
        return True

    def expire(self, now: float) -> List[StreamRequest]:
        """Drop and return queued requests whose deadline already passed."""
        out = []
        keep = deque()
        for sreq in self._q:
            if sreq.deadline_s is not None and now > sreq.deadline_s:
                sreq.status = EXPIRED
                sreq.finish_s = now
                out.append(sreq)
            else:
                keep.append(sreq)
        self._q = keep
        return out

    def pop(self) -> StreamRequest:
        """Remove and return the queue head (FIFO admission order)."""
        return self._q.popleft()


def choose_slot(policy: str, free_slots: np.ndarray,
                slot_load: np.ndarray) -> int:
    """Pick the slot the next admitted request occupies.

    ``fifo`` takes the lowest free slot; ``least-loaded`` the free slot
    with the least cumulative served work (``slot_load``, maintained by
    the runtime; ties break to the lowest index).  Admission *order* is
    always queue-FIFO — the policy only chooses placement, which is what
    keeps streaming outputs bitwise comparable to the synchronous
    engine under either policy.
    """
    if policy not in SLOT_POLICIES:
        raise ValueError(f"unknown slot policy {policy!r} "
                         f"(expected one of {SLOT_POLICIES})")
    if len(free_slots) == 0:
        raise ValueError("no free slot to choose from")
    if policy == SLOT_FIFO:
        return int(free_slots[0])
    loads = slot_load[free_slots]
    return int(free_slots[int(np.argmin(loads))])
