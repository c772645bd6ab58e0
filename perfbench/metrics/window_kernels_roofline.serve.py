"""The port's window kernels' share of their roofline: the least time the
work of the traced windows needs (`perfbench.roofline`, counted from the
reference's events for the same requests) over the device time of the
window kernels in the trace."""
from perfbench import roofline
from perfbench.trace import WINDOW_KERNELS, is_port_kernel

NAME, UNIT, LAYER = "window_kernels_roofline.serve", "%", "kernels"
MOVES, TRACED = "realtime_streams", True


def read(r):
    """The metric from a run's readings; None where there is none."""
    busy = r["trace"].device_s(lambda k: is_port_kernel(k, WINDOW_KERNELS))
    if not r["launches"] or busy <= 0:
        return None
    bound = roofline.serving_bound_s(r["layers"], r["reference"],
                                     r["engine_window"], r["launches"])
    return 100.0 * bound / busy
