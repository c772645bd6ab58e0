"""Streaming runtime: continuous-batching serving for the engine
(counterpart of ``repro.serve.runtime``).

Public surface:

  * :class:`~repro_torch.serve.runtime.pipeline.StreamingRuntime` — the
    double-buffered serve loop (admission, SLO enforcement, telemetry)
    around one `EventServeEngine`, on that engine's device;
  * :class:`~repro_torch.serve.runtime.loadgen.PoissonLoadGen` plus the
    payload builders — open-loop Poisson load over the bundled
    recording or synthetic gestures;
  * :class:`~repro_torch.serve.runtime.clock.WallClock` /
    :class:`~repro_torch.serve.runtime.clock.ManualClock` — injected time;
  * the admission vocabulary (lifecycle states, slot policies,
    :class:`~repro_torch.serve.runtime.admission.StreamRequest`).
"""
from repro_torch.serve.runtime.admission import (DONE, EVICTED, EXPIRED,
                                                 QUEUED, REJECTED, RUNNING,
                                                 SLOT_FIFO, SLOT_LEAST_LOADED,
                                                 SLOT_POLICIES,
                                                 AdmissionQueue,
                                                 StreamRequest, choose_slot)
from repro_torch.serve.runtime.clock import ManualClock, WallClock
from repro_torch.serve.runtime.loadgen import (PoissonLoadGen,
                                               poisson_arrival_times,
                                               requests_from_recording,
                                               requests_synthetic)
from repro_torch.serve.runtime.metrics import StreamingMetrics, percentile
from repro_torch.serve.runtime.pipeline import StreamingRuntime

__all__ = [
    "QUEUED", "RUNNING", "DONE", "REJECTED", "EXPIRED", "EVICTED",
    "SLOT_FIFO", "SLOT_LEAST_LOADED", "SLOT_POLICIES",
    "AdmissionQueue", "StreamRequest", "choose_slot",
    "ManualClock", "WallClock",
    "PoissonLoadGen", "poisson_arrival_times", "requests_from_recording",
    "requests_synthetic",
    "StreamingMetrics", "percentile",
    "StreamingRuntime",
]
