"""What every cell shares: finding a cell's files by name, host spans, the
work meter behind ``realtime_streams``, the module check and the result line.

Nothing here imports the port or a reference; the drivers do.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import pathlib
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

BENCH_DIR = pathlib.Path(__file__).resolve().parent
# top-level module names that may not be loaded in a run: JAX and the JAX
# package the port was made from (compared whole: ``repro_torch`` is fine)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: pathlib.Path, name: str):
    """Import one file by its path (names may hold dots and dashes)."""
    modname = "perfbench_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One ``workloads`` entry with everything it names, loaded."""

    name: str
    workload: dict
    config: dict
    mix: dict
    driver: object
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, object]


def resolve(name: str, repo: Optional[pathlib.Path] = None) -> Cell:
    """Find a cell's configuration, traffic mix, driver and per-layer
    readers from ``BENCHMARK.json`` by name: ``configs`` gives the
    configuration's file, ``traffic/<mix>.json`` the mix, whose ``kind``
    names ``drivers/<kind>.py``; each per-layer metric that the cell reports
    is read by ``metrics/<metric>.py``."""
    repo = BENCH_DIR.parent if repo is None else pathlib.Path(repo)
    bench_dir = repo / BENCH_DIR.name
    bench = json.loads((repo / "BENCHMARK.json").read_text())
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg_entry = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    config = json.loads((repo / cfg_entry["file"]).read_text())
    mix = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json")
                     .read_text())
    driver = load_module(bench_dir / "drivers" / f"{mix['kind']}.py",
                         mix["kind"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moves)]
    readers = {m["name"]: load_module(bench_dir / "metrics"
                                      / f"{m['name']}.py", m["name"])
               for m in per_layer}
    return Cell(name, w, config, mix, driver, e2e, per_layer, readers)


class Spans:
    """Host spans on one clock, kept in memory: name -> [(start, end)].

    :meth:`wrap` replaces a method on one instance by a timed call; the
    callback, if any, sees the result, the span and the arguments.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.records: Dict[str, List[Tuple[float, float]]] = {}

    def wrap(self, obj, attr: str, name: str, on_result=None) -> None:
        """Time every call of ``obj.attr`` as a span ``name``."""
        inner = getattr(obj, attr)
        out = self.records.setdefault(name, [])

        def timed(*args, **kwargs):
            t0 = self.clock()
            result = inner(*args, **kwargs)
            t1 = self.clock()
            out.append((t0, t1))
            if on_result is not None:
                on_result(result, t0, t1, *args)
            return result
        setattr(obj, attr, timed)

    @contextlib.contextmanager
    def span(self, name: str):
        """Time the body of a ``with`` block as a span ``name``."""
        t0 = self.clock()
        try:
            yield
        finally:
            self.records.setdefault(name, []).append((t0, self.clock()))


class WorkMeter:
    """Sensor time served, credited when each engine window is accounted.

    A window credits every alive timestep of every participating slot,
    idle-skipped ones included, at the moment it retires (or, when every
    slot was idle-skipped and nothing launched, when it is accounted).
    The served time in ``[t0, t1]`` over ``t1 - t0`` is the number of
    sensors kept up with: work, not completions, so half a request counts
    half.
    """

    def __init__(self, timestep_s: float):
        self.timestep_s = timestep_s
        self.credits: List[Tuple[float, float]] = []   # (time, timesteps)

    def credit(self, t: float, timesteps: float) -> None:
        """Credit ``timesteps`` slot-timesteps served at time ``t``."""
        self.credits.append((t, timesteps))

    def served_s(self, t0: float, t1: float) -> float:
        """Sensor seconds credited in ``(t0, t1]``."""
        return self.timestep_s * sum(n for t, n in self.credits
                                     if t0 < t <= t1)

    def streams(self, t0: float, t1: float) -> float:
        """Sensor seconds served in ``(t0, t1]`` per second."""
        return self.served_s(t0, t1) / (t1 - t0)


def span_ms(readings: dict, name: str) -> Optional[float]:
    """Mean host ms of the spans ``name`` that end inside the traced
    window: their total over their count; None where there is none."""
    t0, t1 = readings["window"]
    inside = [b - a for a, b in readings["spans"].get(name, [])
              if t0 <= b <= t1]
    return 1e3 * sum(inside) / len(inside) if inside else None


@dataclasses.dataclass
class RunContext:
    """What a driver is given.  ``runtime_clock`` replaces the serving
    runtime's wall clock (tests inject one); ``started`` is when the
    process started, so that :meth:`window_opens` records ``setup_s``."""

    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    clock: Callable[[], float] = time.perf_counter
    runtime_clock: object = None
    started: float = dataclasses.field(default_factory=time.perf_counter)
    setup_s: Optional[float] = None

    def window_opens(self) -> None:
        """Record ``setup_s``: the window opens now."""
        self.setup_s = self.clock() - self.started


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end values, the readings the
    per-layer readers take their metrics from, the compared numbers with
    their limits, and the counts of the result line."""

    end_to_end: Dict[str, float]
    readings: Dict[str, object]
    checks: Dict[str, Tuple[float, float]]
    attempted: int
    failed: int
    memory_peak_bytes: int


def correct(checks: Dict[str, Tuple[float, float]]) -> bool:
    """Every compared number at or below its limit (and a number at all)."""
    return bool(checks) and all(v == v and v <= lim
                                for v, lim in checks.values())


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def check_lines(checks: Dict[str, Tuple[float, float]]) -> List[str]:
    """One line per compared number, beside its limit."""
    return [f"check {k} {v!r} limit {lim!r}" for k, (v, lim) in
            checks.items()]


def result_line(outcome: Outcome, metrics: Dict[str, Tuple[float, str]],
                device: dict, breakdown: Optional[dict] = None) -> str:
    """The last line of standard output; the compared numbers come last."""
    out = {"correct": correct(outcome.checks),
           "attempted": int(outcome.attempted),
           "failed": int(outcome.failed),
           "metrics": {k: {"value": v, "unit": u}
                       for k, (v, u) in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in outcome.checks.items()}
    return json.dumps(out)
