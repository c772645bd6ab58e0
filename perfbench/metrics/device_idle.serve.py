"""Share of the traced serving window in which nothing ran on the
device."""
NAME, UNIT, LAYER = "device_idle.serve", "%", "device"
MOVES, TRACED = "realtime_streams", True


def read(r):
    """The metric from a run's readings; None where there is none."""
    tr = r["trace"]
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s) if tr.events else None
