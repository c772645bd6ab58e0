"""Latency/throughput telemetry for the streaming runtime (counterpart of
``repro.serve.runtime.metrics``, copied).

The analytic energy telemetry (`repro_torch.serve.telemetry`) answers "what
would this inference cost on the ASIC"; this module answers the serving
questions the paper's throughput-under-sparsity claim turns into at
system scale: what window latency does a request observe (p50/p99), how
long from arrival to answer, how deep does the queue get, and how many
input events per second does the server *sustain* under open-loop load.

Every completed request still carries its full analytic
:class:`~repro_torch.serve.telemetry.RequestTelemetry`; the streaming summary
rides alongside it, plus the engine's padding-waste accounting
(`EventServeEngine.padding_waste`) so the adaptive-bucketing baseline is
measured wherever streaming telemetry is reported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from repro_torch.serve.runtime.admission import DONE, StreamRequest


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile (``q`` in [0, 100]); nan if empty.

    Tiny and dependency-free on purpose: latency lists are short and the
    gate pins care about determinism, not estimator subtleties.
    """
    if not xs:
        return float("nan")
    s = sorted(float(x) for x in xs)
    if len(s) == 1:
        return s[0]
    pos = (len(s) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    frac = pos - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


@dataclasses.dataclass
class StreamingMetrics:
    """Counters and samples one streaming serve session accumulates."""

    admitted: int = 0
    completed: int = 0
    rejected_queue_full: int = 0
    expired_in_queue: int = 0
    evicted_deadline: int = 0
    window_latencies_s: List[float] = dataclasses.field(default_factory=list)
    queue_depth_samples: List[int] = dataclasses.field(default_factory=list)
    events_served: int = 0       # raw input events collected into windows
    span_s: float = 0.0          # serve-loop clock span

    def summary(self, requests: Sequence[StreamRequest] = ()) -> Dict:
        """Aggregate into the serving-level report.

        ``sustained_events_per_s`` is the headline: input events the
        server collected per second of serve-loop time — the measured
        counterpart of the paper's events/s throughput claim.  Latencies
        are reported in milliseconds.
        """
        e2e = [s.e2e_latency_s for s in requests
               if s.status == DONE and s.e2e_latency_s is not None]
        waits = [s.queue_wait_s for s in requests
                 if s.queue_wait_s is not None]
        depth = self.queue_depth_samples
        return {
            "admitted": self.admitted,
            "completed": self.completed,
            "rejected_queue_full": self.rejected_queue_full,
            "expired_in_queue": self.expired_in_queue,
            "evicted_deadline": self.evicted_deadline,
            "p50_window_latency_ms": percentile(self.window_latencies_s,
                                                50.0) * 1e3,
            "p99_window_latency_ms": percentile(self.window_latencies_s,
                                                99.0) * 1e3,
            "p50_e2e_latency_ms": percentile(e2e, 50.0) * 1e3,
            "p99_e2e_latency_ms": percentile(e2e, 99.0) * 1e3,
            "mean_queue_wait_ms": (sum(waits) / len(waits) * 1e3
                                   if waits else float("nan")),
            "max_queue_depth": max(depth) if depth else 0,
            "mean_queue_depth": (sum(depth) / len(depth)
                                 if depth else 0.0),
            "span_s": self.span_s,
            "events_served": self.events_served,
            "sustained_events_per_s": (self.events_served / self.span_s
                                       if self.span_s > 0 else 0.0),
        }
