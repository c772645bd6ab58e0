"""Fault tolerance: watchdog, preemption handling, straggler accounting.

A copy of ``repro.train.fault`` (pure Python; the port imports nothing of
the reference package).  Production posture (1000+ nodes) mapped to what
is testable in-process:

  * **Preemption / SIGTERM** — :class:`PreemptionGuard` installs a handler
    that flips a flag; the training loop checkpoints and exits cleanly at
    the next step boundary (the standard TPU-pod maintenance-event flow).
  * **Step watchdog** — :class:`StepWatchdog` tracks an EMA of step time;
    a step exceeding ``k x EMA`` is logged as a straggler event and the
    configured callback fires (on a real cluster: report to the job
    controller for hot-spare re-slicing; here: counted + surfaced).
  * **Retries** — :func:`with_retries` wraps transient-failure-prone work
    (checkpoint I/O) with exponential backoff.
  * **Elastic restart** — not in this module: checkpoints hold global
    arrays (train/checkpoint.py), so restoring onto another device is the
    normal restore path.
"""
from __future__ import annotations

import signal
import time
from typing import Callable, List, Optional


class PreemptionGuard:
    """SIGTERM/SIGINT -> request a clean checkpoint-and-exit."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self.requested = False
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


class StepWatchdog:
    """EMA-based straggler detector for the training step."""

    def __init__(self, threshold: float = 3.0, ema_decay: float = 0.9,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None):
        self.threshold = threshold
        self.ema_decay = ema_decay
        self.ema: Optional[float] = None
        self.events: List[dict] = []
        self._t0: Optional[float] = None
        self._on_straggler = on_straggler

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> float:
        dt = time.monotonic() - self._t0
        if self.ema is not None and dt > self.threshold * self.ema:
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
            if self._on_straggler:
                self._on_straggler(step, dt, self.ema)
        self.ema = dt if self.ema is None else (
            self.ema_decay * self.ema + (1 - self.ema_decay) * dt)
        return dt


def with_retries(fn: Callable, n: int = 3, base_delay: float = 0.1,
                 exceptions=(OSError,)):
    """Run ``fn()`` with exponential backoff on transient failures."""
    for attempt in range(n):
        try:
            return fn()
        except exceptions:
            if attempt == n - 1:
                raise
            time.sleep(base_delay * (2 ** attempt))
