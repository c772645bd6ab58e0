"""Useful synaptic operations per second over the traced serving window
(one add per neuron update: the reference's events into each layer times
the updates each makes), as a share of the H100's float32 peak."""
from perfbench import roofline

NAME, UNIT, LAYER = "mfu.serve", "%", "device"
MOVES, TRACED = "realtime_streams", True


def read(r):
    """The metric from a run's readings; None where there is none."""
    if not r["launches"]:
        return None
    ops = roofline.serving_ops(r["layers"], r["reference"],
                               r["engine_window"], r["launches"])
    return 100.0 * ops / r["trace"].window_s / roofline.FP32_OPS_PER_S
