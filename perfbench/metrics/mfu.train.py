"""The training step's float32 operations per second over the traced
window, as a share of the H100's float32 peak.  Operations are counted
from the layer shapes (`perfbench.reference.ecnn.flops_per_frame`): the
dense forward of each frame and twice that for the backward, times batch
and timesteps; elementwise LIF work is not counted."""
from perfbench import roofline
from perfbench.reference.ecnn import flops_per_frame

NAME, UNIT, LAYER = "mfu.train", "%", "device"
MOVES, TRACED = "train_samples_per_s", True


def read(r):
    """The metric from a run's readings; None where there is none."""
    n = r["steps"]
    if not n:
        return None
    ops = 3 * flops_per_frame(r["layers"]) * r["batch"] * r["timesteps"] * n
    return 100.0 * ops / r["trace"].window_s / roofline.FP32_OPS_PER_S
