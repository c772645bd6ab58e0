"""Event-stream serving: the public API (counterpart of ``repro.serve``).

    from repro_torch.serve import (EventRequest, EventServeEngine,
                                   StreamingRuntime, ExecutionPolicy)
    from repro_torch.serve import Request, ServeEngine   # LM serving

Module layout behind the facade:

  * `repro_torch.serve.event_engine` — slot-batched engine + request type
    (the local backend, and the ``policy.backend`` knob);
  * `repro_torch.serve.mesh_engine`  — the slot-sharded ``"mesh"``
    backend over several devices;
  * `repro_torch.serve.runtime`      — streaming runtime (admission, SLOs,
    load generation, clocks, metrics);
  * `repro_torch.serve.telemetry`    — per-request energy/event telemetry;
  * `repro_torch.serve.engine`       — the LM engine: slot-batched
    continuous batching over the decoder stack's caches.
"""
from repro_torch.core.layer_program import default_step_capacities
from repro_torch.core.policies import ExecutionPolicy, all_policies
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.event_engine import (EventRequest, EventServeEngine,
                                            event_bucket, event_bucket_ladder)
from repro_torch.serve.mesh_engine import MeshEventServeEngine
from repro_torch.serve.runtime import (ManualClock, PoissonLoadGen,
                                       StreamingMetrics, StreamingRuntime,
                                       StreamRequest, WallClock,
                                       requests_from_recording,
                                       requests_synthetic)
from repro_torch.serve.telemetry import (RequestTelemetry, proportionality_r2,
                                         request_telemetry, summarize)

__all__ = [
    # engine
    "EventRequest", "EventServeEngine", "MeshEventServeEngine",
    "event_bucket", "event_bucket_ladder", "default_step_capacities",
    # execution policy (re-export: the engine's construction knob)
    "ExecutionPolicy", "all_policies",
    # streaming runtime
    "StreamingRuntime", "StreamRequest", "PoissonLoadGen",
    "StreamingMetrics", "WallClock", "ManualClock",
    "requests_from_recording", "requests_synthetic",
    # telemetry
    "RequestTelemetry", "request_telemetry", "summarize",
    "proportionality_r2",
    # LM serving
    "Request", "ServeEngine",
]
