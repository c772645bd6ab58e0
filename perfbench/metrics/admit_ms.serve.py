"""Host ms per admitted request in ``EventServeEngine.try_admit``, as the
runtime's ``_admit`` calls it (the stream's conversion to numpy and the
collector's stable sort)."""
from perfbench.core import span_ms

NAME, UNIT, LAYER = "admit_ms.serve", "ms", "streaming runtime"
MOVES, TRACED = "realtime_streams", True


def read(r):
    """The metric from a run's readings; None where there is none."""
    return span_ms(r, "admit")
