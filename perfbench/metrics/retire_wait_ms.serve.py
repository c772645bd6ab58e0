"""Host ms per window blocked in the runtime's retire phase
(``EventServeEngine._retire_phase``), its one wait on the device: it grows
as the host gets faster."""
from perfbench.core import span_ms

NAME, UNIT, LAYER = "retire_wait_ms.serve", "ms", "streaming runtime"
MOVES, TRACED = "realtime_streams", True


def read(r):
    """The metric from a run's readings; None where there is none."""
    return span_ms(r, "retire")
