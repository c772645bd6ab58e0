"""Clock abstraction for the streaming runtime (counterpart of
``repro.serve.runtime.clock``, copied).

Every time-dependent decision in the runtime — arrival ingestion, SLO
deadline checks, latency attribution — reads one injected clock, so the
same pipeline runs open-loop against wall time in production
(:class:`WallClock`) and fully deterministically in tests
(:class:`ManualClock`, which advances only when the test says so).
Times are seconds, zeroed at whatever the clock calls its epoch.
"""
from __future__ import annotations

import time


class WallClock:
    """Monotonic wall-clock, zeroed at construction.

    ``wait_until`` really sleeps — this is what paces the open-loop
    serve loop between Poisson arrivals when the engine has drained.
    """

    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        """Seconds since this clock was constructed."""
        return time.monotonic() - self._t0

    def wait_until(self, t: float) -> None:
        """Sleep until clock time ``t`` (no-op if already past)."""
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)


class ManualClock:
    """Deterministic test clock; time moves only when told to.

    ``wait_until`` jumps instead of sleeping, so a serve loop waiting
    for the next scheduled arrival makes progress without real time
    passing — deadline and eviction tests become exact.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        """The current manual time."""
        return self._now

    def advance(self, dt: float) -> None:
        """Move time forward by ``dt`` seconds (must be >= 0)."""
        if dt < 0:
            raise ValueError("time only moves forward")
        self._now += dt

    def wait_until(self, t: float) -> None:
        """Jump to clock time ``t`` (no-op if already past)."""
        self._now = max(self._now, t)
