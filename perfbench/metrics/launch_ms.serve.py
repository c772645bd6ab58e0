"""Host ms per window in the engine's launch phase
(``EventServeEngine._launch_phase``): compaction, pinned staging, the
enqueue of the window step and of the copies back."""
from perfbench.core import span_ms

NAME, UNIT, LAYER = "launch_ms.serve", "ms", "engine"
MOVES, TRACED = "realtime_streams", True


def read(r):
    """The metric from a run's readings; None where there is none."""
    return span_ms(r, "launch")
