"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
window, device activity only (kernels, copies, sets), its times put on the
host's ``perf_counter`` clock so that idle gaps can be labelled by the host
span that was open.  Off (``enabled=False``) it records nothing."""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

# the port's own kernels, by the name the profiler gives them
PORT_KERNELS = ("event_conv_window", "event_pool_window", "event_fc_window",
                "network_window", "event_conv_batched", "event_pool_batched",
                "event_fc_batched", "lif_fused")
WINDOW_KERNELS = PORT_KERNELS[:4]


def is_port_kernel(name: str, which=PORT_KERNELS) -> bool:
    """Whether a device event is one of the port's kernels."""
    return any(k in name for k in which)


def is_copy(name: str) -> bool:
    """Whether a device event is a copy or a set, not a kernel."""
    return name.startswith(("Memcpy", "Memset"))


class DeviceTrace:
    """Start and stop the profiler around a window; after :meth:`stop`,
    ``events`` holds ``(name, start, end)`` on the host clock, ``t0``/``t1``
    the traced window."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.events: List[Tuple[str, float, float]] = []
        self.t0 = self.t1 = None
        self._prof = None

    def start(self) -> None:
        """Start tracing the device (nothing when off)."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._wall_ns, self.t0 = time.time_ns(), time.perf_counter()

    def stop(self) -> None:
        """Stop, and put the device events on the host clock."""
        if not self.enabled:
            return
        import sys
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        res = self._prof.profiler.kineto_results
        start_ns = res.trace_start_ns()
        # the profiler's clock is the wall clock or the monotonic one
        if abs(start_ns - self._wall_ns) < 60e9:
            base_ns = self._wall_ns
        else:
            base_ns = int(self.t0 * 1e9)
        for e in res.events():
            if "CUDA" not in str(e.device_type()):
                continue
            s = self.t0 + (e.start_ns() - base_ns) * 1e-9
            self.events.append((e.name(), s, s + e.duration_ns() * 1e-9))
        self.events.sort(key=lambda x: x[1])
        self._prof = None
        print(f"perfbench: traced {self.window_s:.3f} s, "
              f"{len(self.events)} device events, read in "
              f"{time.perf_counter() - self.t1:.1f} s", file=sys.stderr)

    @property
    def window_s(self) -> float:
        """Length of the traced window."""
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device activity inside the traced window."""
        out: List[List[float]] = []
        for _, s, e in self.events:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        """Seconds of the window in which the device ran anything."""
        return sum(b - a for a, b in self.busy_intervals())

    def device_s(self, keep) -> float:
        """Device seconds of the events whose name ``keep`` accepts."""
        return sum(e - s for n, s, e in self.events if keep(n))

    def count(self, keep) -> int:
        """Device events whose name ``keep`` accepts."""
        return sum(1 for n, _, _ in self.events if keep(n))

    def top_ops(self, n: int = 10) -> List[list]:
        """The ``n`` device operations that took most time, by name."""
        tot: Dict[str, float] = {}
        for name, s, e in self.events:
            tot[name] = tot.get(name, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans: Dict[str, List[Tuple[float, float]]],
                  n: int = 10) -> List[list]:
        """Idle device time by the host span open at each gap's middle
        (``other`` where none is).  The drivers' spans do not overlap."""
        leaves = sorted((s, e, name) for name, rows in spans.items()
                        for s, e in rows)
        starts = [s for s, _, _ in leaves]
        tot: Dict[str, float] = {}
        prev = self.t0
        for a, b in self.busy_intervals() + [(self.t1, self.t1)]:
            if a > prev:
                mid = 0.5 * (prev + a)
                i = bisect.bisect_right(starts, mid) - 1
                label = (leaves[i][2] if i >= 0 and leaves[i][1] >= mid
                         else "other")
                tot[label] = tot.get(label, 0.0) + (a - prev)
            prev = max(prev, b)
        return [[k, v] for k, v in sorted(tot.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def breakdown(self, spans) -> Optional[dict]:
        """The result line's ``breakdown`` (None when off)."""
        if not self.enabled:
            return None
        return {"device_ops": self.top_ops(), "idle_gaps":
                self.idle_gaps(spans)}
