"""Host ms per window in the engine's collector
(``EventServeEngine._collect_phase``): binning each slot's next window of
events into the padded buckets."""
from perfbench.core import span_ms

NAME, UNIT, LAYER = "collect_ms.serve", "ms", "engine"
MOVES, TRACED = "realtime_streams", True


def read(r):
    """The metric from a run's readings; None where there is none."""
    return span_ms(r, "collect")
