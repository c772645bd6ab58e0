"""Device ms per launched window in everything that is not one of the
port's own kernels (the executor's routing: sorts, top-k, ``cat``, copies,
index ops), from the device trace."""
from perfbench.trace import is_port_kernel

NAME, UNIT, LAYER = "route_device_ms.serve", "ms", "executor"
MOVES, TRACED = "realtime_streams", True


def read(r):
    """The metric from a run's readings; None where there is none."""
    n = len(r["launches"])
    if not n:
        return None
    return 1e3 * r["trace"].device_s(lambda k: not is_port_kernel(k)) / n
