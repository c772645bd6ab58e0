"""Poisson open-loop load generation for the streaming runtime.

Counterpart of ``repro.serve.runtime.loadgen``.  Open-loop means the
arrival process never waits for the server: request *i* arrives at its
scheduled time whether or not a slot is free — the sensor fleet does not
back off because the accelerator is busy.  That is the load model under
which tail latency and sustained throughput are meaningful (a closed-loop
client self-throttles and hides overload), and it is what exercises the
admission layer's queueing, rejection and eviction paths.

Arrivals are a homogeneous Poisson process (i.i.d. exponential gaps at
``rate_hz``), deterministic in ``seed`` and drawn with numpy exactly as
the reference draws them.  Payloads replay a DVS recording
(:func:`requests_from_recording`) or synthetic gestures
(:func:`requests_synthetic`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.data.events_ds import (load_recording, sample_recording_path,
                                        segment_recording,
                                        synthesize_recording)
from repro_torch.serve.event_engine import EventRequest
from repro_torch.serve.runtime.admission import StreamRequest


def poisson_arrival_times(rate_hz: float, n: int,
                          seed: int = 0) -> np.ndarray:
    """Cumulative arrival times of ``n`` Poisson arrivals at ``rate_hz``.

    Deterministic in ``seed`` (numpy Generator semantics are stable
    across platforms); the first arrival is one exponential gap after
    time zero.
    """
    if rate_hz <= 0:
        raise ValueError("rate_hz must be > 0")
    if n < 0:
        raise ValueError("n must be >= 0")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_hz, size=n))


def requests_from_recording(n_requests: int, in_shape, n_timesteps: int,
                            window_us: int = 1000,
                            path: Optional[str] = None) -> List[EventRequest]:
    """Build ``n_requests`` replay payloads from a recording, cycling it.

    Default path is the bundled sample recording.  Each request is a
    fresh :class:`EventRequest` object (uids ``0..n_requests-1``) so one
    payload list can be served once; build a new list per serve run.
    """
    rec = load_recording(path or sample_recording_path())
    segs = segment_recording(rec, in_shape, n_timesteps, window_us)
    return [dataclasses.replace(segs[i % len(segs)], uid=i)
            for i in range(n_requests)]


# the reference's ``TINY`` dataset geometry: 12x12, two polarities, T = 16,
# 4 classes; 1 ms bins
TINY_SHAPE, TINY_T, TINY_CLASSES, TINY_WINDOW_US = (12, 12, 2), 16, 4, 1000
TINY_RATE_HZ = 20_000.0     # about the reference's 6% base activity


def requests_synthetic(n_requests: int, seed: int = 0) -> List[EventRequest]:
    """Synthetic gesture payloads (controllable, no file I/O) for tests.

    The reference draws ``TINY`` gestures with JAX's PRNG
    (``repro.data.events_ds.batch_at``), which cannot be reproduced here,
    so these are drawn with numpy instead, at the same geometry: request
    ``i`` is one :func:`~repro_torch.data.events_ds.synthesize_recording`
    of ``TINY_T`` 1 ms bins (its seed drawn from ``seed``, label
    ``i % 4``), binned by
    :func:`~repro_torch.data.events_ds.segment_recording`.  The same
    ``seed`` gives the same requests; they are not the reference's.
    """
    H, W, _ = TINY_SHAPE
    seeds = np.random.default_rng(seed).integers(0, 2**31, n_requests)
    out = []
    for i, s in enumerate(seeds):
        rec = synthesize_recording(seed=int(s), width=W, height=H,
                                   duration_us=TINY_T * TINY_WINDOW_US,
                                   rate_hz=TINY_RATE_HZ,
                                   label=i % TINY_CLASSES)
        out += segment_recording(rec, TINY_SHAPE, TINY_T, TINY_WINDOW_US,
                                 uid_base=i)[:1]
    return out


class PoissonLoadGen:
    """Open-loop Poisson arrival process over a fixed payload list.

    The runtime polls :meth:`due` each pipeline tick; every payload
    whose arrival time has passed is handed over as a
    :class:`StreamRequest` (with its absolute SLO deadline already
    stamped, ``arrival + slo_s``) regardless of queue or slot state —
    admission control is the runtime's problem, arrival is not.
    """

    def __init__(self, requests: Sequence[EventRequest], rate_hz: float,
                 seed: int = 0, slo_s: Optional[float] = None,
                 start_s: float = 0.0):
        self.requests = list(requests)
        self.rate_hz = float(rate_hz)
        self.slo_s = slo_s
        self.arrivals = start_s + poisson_arrival_times(
            rate_hz, len(self.requests), seed)
        self._next = 0

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def exhausted(self) -> bool:
        """True when every arrival has been handed to the runtime."""
        return self._next >= len(self.requests)

    def next_arrival_s(self) -> Optional[float]:
        """Clock time of the next pending arrival (None if exhausted)."""
        if self.exhausted:
            return None
        return float(self.arrivals[self._next])

    def due(self, now: float) -> List[StreamRequest]:
        """Hand over every arrival with ``arrival_s <= now``, in order."""
        out = []
        while (self._next < len(self.requests)
               and self.arrivals[self._next] <= now):
            t = float(self.arrivals[self._next])
            out.append(StreamRequest(
                req=self.requests[self._next], arrival_s=t,
                deadline_s=(t + self.slo_s
                            if self.slo_s is not None else None)))
            self._next += 1
        return out
