#!/usr/bin/env python3
"""Run the PyTorch/CUDA port end to end on one NVIDIA GPU and check it.

Usage, from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (each ends with ``torch.cuda.synchronize()``; any failure exits
non-zero):

1. device and build — the card's name and power limit, the torch and CUDA
   versions, and the build of every ``src/repro_torch/kernels/csrc/*.cu``;
2. each CUDA scatter kernel against its plain PyTorch version on the card,
   at the Fig. 6 layer shapes (8 slots), under every dtype pairing, bitwise
   (``torch.equal``), with kernel and plain times, and the time of
   PyTorch's library route to the same slab (checked against the kernel
   to float32 rounding);
3. the trained tiny checkpoint served through the port's engine
   (per-step, both dtype policies) against ``tests/golden/
   tiny_gesture_trained_serve.npz``, key for key;
4. the main path: the full-width Fig. 6 network (``dvs_gesture_net()``,
   128x128x2, T = 100, seeded random weights quantised to int4) serving two
   cohorts of 8 synthetic DVS recordings (about 1.2% and 4.9% input
   activity) on 8 slots under both dtype policies, which must agree
   bitwise; all three kernels must have launched; a T = 8 cut of two
   requests is also served by the plain CPU path and must agree bitwise.

The line before the last holds the card's ``nvidia-smi`` name and power
limit; before it, one JSON line of per-kernel numbers; the last line is
the device JSON.  Without a CUDA device, or without the repository's
``src/repro_torch`` beside this file, it prints no result and exits
non-zero.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from functools import partial

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden",
                      "tiny_gesture_trained_serve.npz")
N_SLOTS = 8
WINDOW = 4
WINDOW_US = 1000
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
LIB_RTOL, LIB_ATOL = 1e-4, 1e-3   # library yardstick vs kernel (f32 order)
COHORTS = (("1.2%", 450e3), ("4.9%", 3.4e6))   # (target activity, rate_hz)
REPLACES = {
    "event_conv_batched": "src/repro/kernels/event_conv/kernel.py:114",
    "event_pool_batched": "src/repro/kernels/event_pool/kernel.py:102",
    "event_fc_batched": "src/repro/kernels/event_fc/kernel.py:95",
}
SOURCES = {
    "event_conv_batched": "src/repro_torch/kernels/csrc/event_conv.cu",
    "event_pool_batched": "src/repro_torch/kernels/csrc/event_pool.cu",
    "event_fc_batched": "src/repro_torch/kernels/csrc/event_fc.cu",
}


def log(*a):
    """Progress line on stdout (flushed: the run is read after the fact)."""
    print(*a, flush=True)


def nvidia_smi() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the device (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at the Fig. 6 shapes
# ---------------------------------------------------------------------------

def _layer_inputs(op, rng, pairing: str, dev):
    """Slab, weights, events and gates for one layer at the main path's
    shapes: layer 0 gets a collector bucket at a mid ladder rung; later
    layers get what ``frame_to_events`` routes from a frame with that many
    spikes (``min(cap, sites)`` events, the spikes first)."""
    import numpy as np
    import torch
    from repro_torch.core.layer_program import frame_to_events
    from repro_torch.serve.event_engine import event_bucket_ladder
    spec = op.spec
    H, W, C = spec.in_shape
    Ho, Wo, Co = spec.out_shape
    h = op.halo
    ladder = event_bucket_ladder(op.step_capacity)
    rung = ladder[len(ladder) // 2]
    N = N_SLOTS
    if op.index == 0:
        E = rung
        xyc = np.stack([rng.integers(0, H, (N, E)), rng.integers(0, W, (N, E)),
                        rng.integers(0, C, (N, E))], -1).astype(np.int32)
        gate = np.zeros((N, E), np.float32)
        gate[:, : (4 * E) // 5] = 1.0
        xyc_t = torch.from_numpy(xyc).to(dev)
        gate_t = torch.from_numpy(gate).to(dev)
    else:
        frame = np.zeros((N, H * W * C), np.float32)
        for n in range(N):
            frame[n, rng.choice(H * W * C, min(rung, H * W * C),
                                replace=False)] = 1.0
        xyc_t, gate_t, _ = frame_to_events(
            torch.from_numpy(frame.reshape(N, H, W, C)).to(dev),
            op.step_capacity)
    if spec.kind == "conv":
        xyc_t = xyc_t + torch.tensor([spec.padding, spec.padding, 0],
                                     dtype=torch.int32, device=dev)
    wshape = spec.weight_shape
    slab = (N, Ho + 2 * h, Wo + 2 * h, Co)
    if pairing == "f32":
        # unquantised float weights: accumulation order is visible
        w = rng.standard_normal(wshape).astype(np.float32)
        v = rng.standard_normal(slab).astype(np.float32)
        gdt, out_dtype = torch.float32, torch.float32
    else:
        w = rng.integers(-8, 8, wshape).astype(np.int8)
        if pairing == "int8":
            v = rng.integers(-127, 128, slab).astype(np.int8)
            gdt = torch.int8
        else:
            v = rng.integers(-1000, 1000, slab).astype(np.int32)
            gdt = torch.int32
        out_dtype = torch.int32
    return (torch.from_numpy(v).to(dev), torch.from_numpy(w).to(dev),
            xyc_t.contiguous(), gate_t.to(gdt).contiguous(), out_dtype)


def _bound(op, v, w, xyc, gate, out_dtype):
    """Least time for one launch's work: bytes (each input read once, each
    output written once; fc reads only the rows its gated events name)
    over the memory rate, or operations (one multiply and one add per
    neuron update of a gated event) over the float32 rate — the larger."""
    import torch
    spec = op.spec
    active = gate != 0
    n_active = int(active.sum())
    if spec.kind == "fc":
        Hi, Wi, Ci = spec.in_shape
        rows = (xyc[..., 0].long() * Wi + xyc[..., 1].long()) * Ci \
            + xyc[..., 2].long()
        w_bytes = int(torch.unique(rows[active]).numel()) * w.shape[1] \
            * w.element_size()
    else:
        w_bytes = w.numel() * w.element_size()
    out_bytes = v.numel() * torch.empty((), dtype=out_dtype).element_size()
    nbytes = (v.numel() * v.element_size() + out_bytes + w_bytes
              + xyc.numel() * 4 + gate.numel() * gate.element_size())
    ops = 2 * n_active * spec.updates_per_event()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _library_call(op, v, w, xyc, gate):
    """PyTorch's own route to the same scatter (f32 only), timed whole: the
    events are summed into a dense frame with ``index_add_`` and one library
    call applies the weights — a transposed convolution whose output is the
    (Hp, Wp) slab, added to ``v``, for conv; ``index_add`` into ``v`` for
    pool; one ``addmm`` onto ``v`` for fc.  Returns the slab the kernel
    returns, (N, Hp, Wp, Co)."""
    import torch
    import torch.nn.functional as F
    spec = op.spec
    N = v.shape[0]
    H, W, C = spec.in_shape

    def coords():
        x, y, c = (xyc[..., k].long() for k in range(3))
        return torch.arange(N, device=v.device)[:, None].expand_as(x), x, y, c

    def frame(shape, flat):
        # (N, *shape) zeros with each event's gate added at its flat site
        size = shape[0] * shape[1] * shape[2]
        return torch.zeros(N * size, device=v.device).index_add_(
            0, flat.reshape(-1), gate.reshape(-1)).reshape(N, *shape)

    if spec.kind == "conv":
        K = w.shape[0]
        Hf, Wf = v.shape[1] - K + 1, v.shape[2] - K + 1

        def conv():
            # events are in halo coordinates: a (Hp-K+1, Wp-K+1) frame
            # transposed-convolved by K gives the (Hp, Wp) slab
            nid, x, y, c = coords()
            dense = frame((C, Hf, Wf), ((nid * C + c) * Hf + x) * Wf + y)
            wt = torch.flip(w, (0, 1)).permute(2, 3, 0, 1)
            return v + F.conv_transpose2d(dense, wt).permute(0, 2, 3, 1)
        return conv
    if spec.kind == "pool":
        Ho, Wo, Co = spec.out_shape
        s = spec.stride

        def pool():
            # the Fig. 6 pools tile their input exactly: no VALID drops
            nid, x, y, c = coords()
            site = ((nid * Ho + x // s) * Wo + y // s) * Co + c
            return v.reshape(-1).index_add(0, site.reshape(-1),
                                           (w[c] * gate).reshape(-1)
                                           ).reshape(v.shape)
        return pool

    def fc():
        nid, x, y, c = coords()
        A = frame((1, 1, w.shape[0]), nid * w.shape[0] + (x * W + y) * C + c)
        return torch.addmm(v.reshape(N, -1), A.reshape(N, -1),
                           w).reshape(v.shape)
    return fc


def phase_kernels(program, dev) -> dict:
    """Every kernel against its plain version, every pairing, bitwise."""
    import numpy as np
    import torch
    from repro_torch.kernels.event_conv.ops import event_conv_batched
    from repro_torch.kernels.event_conv.ref import event_conv_batched_ref
    from repro_torch.kernels.event_fc.ops import event_fc_batched
    from repro_torch.kernels.event_fc.ref import event_fc_batched_ref
    from repro_torch.kernels.event_pool.ops import event_pool_batched
    from repro_torch.kernels.event_pool.ref import event_pool_batched_ref
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1234)
    rows = []
    for op in program.ops:
        spec = op.spec
        for pairing in ("f32", "int8", "int32"):
            v, w, xyc, gate, out_dtype = _layer_inputs(op, rng, pairing, dev)
            if spec.kind == "conv":
                name = "event_conv_batched"
                args = (v, w, xyc, gate, out_dtype)
                kern = partial(event_conv_batched, *args)
                plain = partial(event_conv_batched_ref, *args)
            elif spec.kind == "pool":
                name = "event_pool_batched"
                args = (v, w, xyc, gate, spec.stride, out_dtype)
                kern = partial(event_pool_batched, *args)
                plain = partial(event_pool_batched_ref, *args)
            else:
                name = "event_fc_batched"
                args = (v, w, xyc, gate, spec.in_shape, out_dtype)
                kern = partial(event_fc_batched, *args)
                plain = partial(event_fc_batched_ref, *args)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if got.dtype != want.dtype or not torch.equal(got, want):
                diff = (got.double() - want.double()).abs().max().item()
                raise AssertionError(f"{name} layer {op.index} {pairing}: "
                                     f"kernel != plain (max |diff| {diff})")
            err = (got.double() - want.double()).abs().max().item()
            bound_ms, bound_by = _bound(op, v, w, xyc, gate, out_dtype)
            lib_ms = lib_err = None
            if pairing == "f32":
                lib = _library_call(op, v, w, xyc, gate)
                lib_out = lib()
                lib_err = (lib_out.double() - got.double()).abs().max().item()
                # the library sums in another order (atomics, GEMM tiles):
                # equal to float32 rounding, not bitwise
                if not torch.allclose(lib_out, got, rtol=LIB_RTOL,
                                      atol=LIB_ATOL):
                    raise AssertionError(
                        f"{name} layer {op.index}: the library yardstick "
                        f"computes another function (max |diff| {lib_err})")
                lib_ms = cuda_ms(lib, 20)
            row = {"kernel": name, "layer": op.index, "pairing": pairing,
                   "N": v.shape[0], "slab": list(v.shape[1:]),
                   "E": int(xyc.shape[1]),
                   "gated_events": int((gate != 0).sum()),
                   "ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 1, 1),
                   "library_ms": lib_ms, "library_max_abs_err": lib_err,
                   "bound_ms": bound_ms,
                   "bound_by": bound_by, "max_abs_err": err}
            rows.append(row)
            log(f"  {name:20s} layer {op.index} {pairing:5s} slab "
                f"{tuple(v.shape)} E={row['E']:5d} gated={row['gated_events']:5d}"
                f"  kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.2f} ms"
                f"  library {lib_ms if lib_ms is None else round(lib_ms, 4)}"
                f" ms  bound {bound_ms:.5f} ms ({bound_by})  equal")
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# phases 3 and 4: serving through the engine
# ---------------------------------------------------------------------------

def serve(spec, qn, reqs, dtype_policy, n_slots, dev, window_ms=None):
    """Serve ``reqs`` on a fresh engine; return (requests, engine, wall s)."""
    import torch
    from repro_torch.core.policies import ExecutionPolicy
    from repro_torch.serve import EventServeEngine
    eng = EventServeEngine(qn.spec, qn.params_for(dtype_policy),
                           n_slots=n_slots, window=WINDOW, device=dev,
                           policy=ExecutionPolicy(dtype_policy=dtype_policy,
                                                  fusion_policy="per-step"))
    pending = list(reqs)
    for r in pending:
        eng.validate_request(r)
    t0 = time.perf_counter()
    while True:
        while pending and eng.try_admit(pending[0]):
            pending.pop(0)
        tw = time.perf_counter()
        n = eng.step()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if window_ms is not None and n:
            window_ms.append(1e3 * (time.perf_counter() - tw))
        if n == 0 and not pending:
            break
    return reqs, eng, time.perf_counter() - t0


def results(reqs) -> dict:
    """The per-request outputs compared across runs (wall time excluded)."""
    import numpy as np
    tele = [r.telemetry for r in reqs]
    out = {
        "class_counts": np.stack([r.class_counts for r in reqs]),
        "predictions": np.asarray([r.prediction for r in reqs], np.int64),
        "per_layer_events": np.stack([np.asarray(t.per_layer_events)
                                      for t in tele]),
        "inter_layer_dropped": np.stack([np.asarray(t.inter_layer_dropped)
                                         for t in tele]),
        "input_dropped": np.asarray([t.input_dropped for t in tele], np.int64),
    }
    for f in ("n_windows", "activity", "sne_time_s", "sne_time_par_s",
              "sne_energy_j", "sne_power_w", "n_dense_timesteps",
              "n_skipped_windows"):
        out[f] = np.asarray([getattr(t, f) for t in tele])
    return out


def assert_same(a: dict, b: dict, what: str) -> None:
    """Every key equal, exactly."""
    import numpy as np
    for k in a:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"{what}: {k} differs")


def phase_golden(dev) -> None:
    """The trained checkpoint through the engine equals the golden npz."""
    import numpy as np
    import torch
    from repro_torch.core.quant import quantize_net
    from repro_torch.core.sne_net import tiny_net
    from repro_torch.data.events_ds import (load_recording,
                                            sample_recording_path,
                                            segment_recording)
    from repro_torch.weights import load_net
    spec = tiny_net()
    params, _ = load_net(sample_recording_path("tiny_gesture_trained.npz"),
                         spec, device=dev)
    qn = quantize_net(params, spec, per_channel=False)
    gold = np.load(GOLDEN)
    for dp in ("f32-carrier", "int8-native"):
        reqs = segment_recording(load_recording(sample_recording_path()),
                                 qn.spec.in_shape, qn.spec.n_timesteps,
                                 WINDOW_US)
        reqs, _, wall = serve(spec, qn, reqs, dp, 2, dev)
        res = results(reqs)
        for k in gold.files:
            if not np.array_equal(res[k], gold[k]):
                raise AssertionError(f"trained golden {dp}: {k} differs:\n"
                                     f"{res[k]}\nvs\n{gold[k]}")
        log(f"  {dp}: {len(reqs)} requests equal the golden "
            f"({', '.join(gold.files)}), {wall:.3f} s")
    torch.cuda.synchronize()


def _cohort(spec, rate_hz: float, seed0: int, n: int, T: int):
    from repro_torch.data.events_ds import (segment_recording,
                                            synthesize_recording)
    H, W, _ = spec.in_shape
    reqs = []
    for i in range(n):
        rec = synthesize_recording(seed=seed0 + i, width=W, height=H,
                                   duration_us=T * WINDOW_US,
                                   rate_hz=rate_hz, label=i % 11)
        reqs += segment_recording(rec, spec.in_shape, T, WINDOW_US,
                                  uid_base=seed0 + i)
    return reqs


def phase_full_width(dev, smi: str) -> dict:
    """The main path: full-width Fig. 6 serving under both policies."""
    import numpy as np
    import torch
    from repro_torch.core.quant import quantize_net
    from repro_torch.core.sne_net import dvs_gesture_net, init_snn
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    spec = dvs_gesture_net()
    T = spec.n_timesteps
    params = init_snn(np.random.default_rng(0), spec, device=dev)
    qn = quantize_net(params, spec)
    H, W, C = spec.in_shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    per_policy = {}
    report = []
    for dp in ("f32-carrier", "int8-native"):
        per_cohort = []
        for ci, (label, rate) in enumerate(COHORTS):
            reqs = _cohort(spec, rate, 100 * ci, N_SLOTS, T)
            before = dict(LAUNCHES)
            win_ms = []
            reqs, eng, wall = serve(spec, qn, reqs, dp, N_SLOTS, dev, win_ms)
            res = results(reqs)
            per_cohort.append(res)
            n_in = sum(float(r.telemetry.per_layer_events[0]) for r in reqs)
            act = n_in / (len(reqs) * T * H * W * C)
            launches = sum(LAUNCHES[k] - before[k] for k in LAUNCHES)
            row = {"policy": dp, "cohort": label, "rate_hz": rate,
                   "requests": len(reqs), "input_activity": act,
                   "wall_s": wall, "requests_per_s": len(reqs) / wall,
                   "input_events_per_s": n_in / wall,
                   "windows": len(win_ms),
                   "p50_window_ms": float(np.percentile(win_ms, 50)),
                   "kernel_launches_per_window": launches / len(win_ms),
                   "predictions": res["predictions"].tolist()}
            report.append(row)
            log(f"  {dp} cohort {label} ({rate:.0f} Hz): activity "
                f"{act:.4%}, {row['requests_per_s']:.3f} req/s, "
                f"{row['input_events_per_s']:.0f} input events/s, p50 "
                f"window {row['p50_window_ms']:.3f} ms, "
                f"{row['kernel_launches_per_window']:.2f} launches/window "
                f"[{smi}]")
            counts = res["class_counts"]
            if counts.shape != (len(reqs), spec.n_classes) or \
                    not np.isfinite(counts).all():
                raise AssertionError(f"bad class counts {counts.shape}")
        per_policy[dp] = per_cohort
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"  peak device memory {peak / 2**20:.1f} MiB [{smi}]")
    for a, b in zip(per_policy["f32-carrier"], per_policy["int8-native"]):
        assert_same(a, b, "f32-carrier vs int8-native")
    log("  f32-carrier and int8-native agree bitwise on every request")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    log(f"  launches on the main path: {launches}")
    # the same path cut to T = 8, served by the card and by the plain CPU
    # path, must agree bitwise
    short = dvs_gesture_net(n_timesteps=8)
    qs = quantize_net(init_snn(np.random.default_rng(0), short, device=dev),
                      short)
    qc = quantize_net(init_snn(np.random.default_rng(0), short,
                               device="cpu"), short)
    for dp in ("f32-carrier", "int8-native"):
        got = results(serve(short, qs, _cohort(short, 2e6, 7, 2, 8), dp, 2,
                            dev)[0])
        want = results(serve(short, qc, _cohort(short, 2e6, 7, 2, 8), dp, 2,
                             torch.device("cpu"))[0])
        assert_same(got, want, f"full width T=8 {dp}: card vs plain CPU")
    log("  full width, T = 8: card equals the plain CPU path, both policies")
    return {"launches": launches, "serving": report,
            "peak_device_memory_bytes": peak,
            "trace": trace_cohort(spec, qn, dev, smi)}


def trace_cohort(spec, qn, dev, smi: str) -> dict:
    """Serve the 4.9% cohort once more (f32 carrier) under
    ``torch.profiler``: the device-busy share of the traced wall time and
    the device time by kernel name (the trace itself is too large to keep).
    """
    from torch.profiler import ProfilerActivity, profile
    reqs = _cohort(spec, COHORTS[1][1], 100, N_SLOTS, spec.n_timesteps)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = serve(spec, qn, reqs, "f32-carrier", N_SLOTS, dev)
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    out = {"wall_ms": 1e3 * wall, "device_kernel_ms": device_ms,
           "device_busy_share": device_ms / (1e3 * wall) if device_ms
           else None,
           "top_kernels": [{"name": e.key[:80], "calls": e.count,
                            "device_ms": e.self_device_time_total / 1e3}
                           for e in top]}
    share = ("not measured (no device time in the trace)"
             if out["device_busy_share"] is None
             else f"{out['device_busy_share']:.2%}")
    log(f"  traced cohort: wall {out['wall_ms']:.1f} ms, device kernels "
        f"{device_ms:.1f} ms, device busy {share} [{smi}]")
    for k in out["top_kernels"]:
        log(f"    {k['device_ms']:9.2f} ms  {k['calls']:6d} calls  "
            f"{k['name']}")
    return out


def main() -> int:
    """Run every phase; 0 only if all passed."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs the port on "
              "the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3
    from repro_torch.core.layer_program import compile_program
    from repro_torch.core.quant import quantize_net
    from repro_torch.core.sne_net import dvs_gesture_net, init_snn
    from repro_torch.kernels import _build
    import numpy as np

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"phase 1: device and build — {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    secs = _build.build_all()
    n_src = len(list(_build.CSRC.glob("*.cu")))
    log(f"  built {len(_build.BUILD_LOG)} of {n_src} CUDA sources in "
        f"{secs:.1f} s (the rest were already built)")
    for src, text in sorted(_build.BUILD_LOG.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {src}: {line.strip()}")
    torch.cuda.synchronize()

    log("phase 2: kernels against their plain versions at the Fig. 6 shapes")
    spec = dvs_gesture_net()
    qspec = quantize_net(init_snn(np.random.default_rng(0), spec,
                                  device="cpu"), spec).spec
    program = compile_program(qspec, device=dev)
    rows = phase_kernels(program, dev)

    log("phase 3: trained checkpoint against the golden")
    phase_golden(dev)

    log("phase 4: full-width Fig. 6 serving (the main path)")
    main_path = phase_full_width(dev, smi)

    kernels = []
    for name in REPLACES:
        mine = [r for r in rows if r["kernel"] == name]
        f32 = [r for r in mine if r["pairing"] == "f32"]
        # per-timestep cost on the path: one launch per layer of this kind
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": main_path["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in f32),
            "plain_ms": sum(r["plain_ms"] for r in f32),
            "bound_ms": sum(r["bound_ms"] for r in f32),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in f32)
            else "operations",
            "library_ms": sum(r["library_ms"] for r in f32),
            "layers": [r["layer"] for r in f32],
            "per_shape": mine,
        })
    summary = {"serving": main_path["serving"],
               "peak_device_memory_bytes":
                   main_path["peak_device_memory_bytes"],
               "trace": main_path["trace"], "build_s": secs,
               "total_s": time.perf_counter() - t_start, "card": smi}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, **summary}, f, indent=1)
    log(json.dumps(summary))
    log(json.dumps({"kernels": [{k: v for k, v in kk.items()
                                 if k != "per_shape"} for kk in kernels]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
