#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the machine's card(s).

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Finds the cell's configuration, traffic mix, driver and per-layer readers
by name (`perfbench.core.resolve`), runs the driver (set-up, the measured
window, the comparison with the plain reference), and prints the result
as the last line of standard output: the end-to-end metrics with
``--trace 0``, the per-layer ones with ``--trace 1``.  Exits non-zero with
no result without enough CUDA cards, without the port, or when JAX or the
JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# one host thread everywhere: steadier runs, and the same in every run
THREADS = 1
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = str(THREADS)
REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]

from perfbench import core  # noqa: E402


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    """Run one cell; 0 with a result line, non-zero with none."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = core.resolve(args.workload)

    import torch
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"perfbench: the port is missing ({e})", file=sys.stderr)
        return 3
    torch.set_num_threads(THREADS)
    torch.set_num_interop_threads(THREADS)
    print(f"perfbench: host threads torch {torch.get_num_threads()}, "
          f"interop {torch.get_num_interop_threads()}, "
          f"OMP_NUM_THREADS {os.environ['OMP_NUM_THREADS']}; "
          f"card {power_limit()}", file=sys.stderr, flush=True)

    ctx = core.RunContext(config=cell.config, mix=cell.mix, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          device=torch.device("cuda", 0), started=T_START)
    outcome = cell.driver.run(ctx)

    bad = core.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    breakdown = None
    if args.trace:
        tr = outcome.readings["trace"]
        device["busy_s"], device["window_s"] = tr.busy_s(), tr.window_s
        metrics = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]].read(outcome.readings)
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
        breakdown = tr.breakdown(outcome.readings["spans"])
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: (v, units[k]) for k, v in outcome.end_to_end.items()
                   if k in units}
        metrics["setup_s"] = (ctx.setup_s, units["setup_s"])
    for line in core.check_lines(outcome.checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(core.result_line(outcome, metrics, device, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
