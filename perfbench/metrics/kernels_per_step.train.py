"""Device kernels per training step in the trace (copies and sets left
out): a count that fusing the LIF loop cuts."""
from perfbench.trace import is_copy

NAME, UNIT, LAYER = "kernels_per_step.train", "kernels", "train step"
MOVES, TRACED = "train_samples_per_s", True


def read(r):
    """The metric from a run's readings; None where there is none."""
    n = r["steps"]
    return r["trace"].count(lambda k: not is_copy(k)) / n if n else None
