"""Event-domain serving: the slot-batched engine and per-request telemetry
(counterparts of ``repro.serve``)."""
from repro_torch.serve.event_engine import (EventRequest, EventServeEngine,
                                            event_bucket, event_bucket_ladder)
from repro_torch.serve.telemetry import (RequestTelemetry, request_telemetry,
                                         summarize)

__all__ = ["EventRequest", "EventServeEngine", "event_bucket",
           "event_bucket_ladder", "RequestTelemetry", "request_telemetry",
           "summarize"]
