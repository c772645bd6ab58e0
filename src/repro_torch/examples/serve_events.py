"""Serve concurrent DVS event streams through the slot-batched engine.

    PYTHONPATH=src python -m repro_torch.examples.serve_events \\
        [--requests 8] [--slots 4] [--window 4] [--no-idle-skip] \\
        [--dtype-policy int8-native] [--fusion-policy per-step] \\
        [--backend mesh [--devices 2 | --devices cuda:0,cuda:0]] \\
        [--device cpu]
    ... --source file [--file path/to/recording.npz|.aedat] [--speedup 2000]
    ... --mode streaming [--arrival-rate 200] [--queue-cap 16] [--slo-ms 500]

Two sources:

  * ``--source synthetic`` (default): tiny synthetic DVS recordings are
    admitted all at once into the fixed-slot event engine;
  * ``--source file``: a real recording (AEDAT3.1 or the portable .npz
    event format; default: the bundled sample) is segmented into
    per-inference requests and replayed at sensor pace: the
    ``ReplayClient`` admits each segment at its recording-relative arrival
    time and paces engine windows to (scaled) sensor time.

All active slots advance together through the per-window step: fused
windows by default (one kernel launch per layer per window), the
per-timestep lowering with ``--fusion-policy per-step`` (one launch per
layer per timestep), the whole-network megakernel with
``--fusion-policy fused-network`` (one launch per window).  With the
window-level idle skip (default on) all-idle (slot, window) pairs skip
the launch and their leak is applied analytically.  ``--dtype-policy
int8-native`` quantises the net (`core.quant.quantize_net`) and serves it
on the native integer datapath.  ``--backend mesh`` shards the slot axis
over ``--devices``: a count of cards, or a comma-separated device list
(repeats allowed, e.g. ``cuda:0,cuda:0`` or ``cpu,cpu``); without it,
every visible card (or the one ``--device``).  The knobs together form
the `ExecutionPolicy` the engine is built with.  Each completed inference
reports its event counts mapped through the analytic SNE hardware model:
latency, energy and activity per request.

``--mode streaming`` serves the same requests through the
double-buffered `StreamingRuntime` instead of the synchronous ``run``:
arrivals follow an open-loop Poisson process at ``--arrival-rate``
requests/s, admission is a bounded queue (``--queue-cap``) with graceful
rejection, and ``--slo-ms`` gives every request a deadline (expiry in
the queue, eviction mid-service).  It reports sustained events/s and
window-latency percentiles beside the analytic telemetry.

It runs on the CUDA device unless ``--device cpu`` is given; there the
wrappers run the kernels' plain PyTorch versions.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.econv import EConvParams
from repro_torch.core.policies import (BACKEND_LOCAL, BACKENDS,
                                       DTYPE_POLICIES, F32_CARRIER,
                                       FUSED_WINDOW, FUSION_POLICIES,
                                       INT8_NATIVE)
from repro_torch.core.quant import quantize_net
from repro_torch.core.sne_net import init_snn, tiny_net
from repro_torch.data.events_ds import (TINY, ReplayClient, batch_at,
                                        load_recording, sample_recording_path,
                                        segment_recording)
from repro_torch.device import resolve_device
from repro_torch.kernels import LAUNCHES
from repro_torch.serve import (EventRequest, EventServeEngine,
                               ExecutionPolicy, PoissonLoadGen,
                               StreamingRuntime, proportionality_r2,
                               summarize)
from repro_torch.train.snn_loop import load_trained_tiny


def parse_devices(text):
    """``--devices``: None, a count of cards, or a list of devices."""
    if text is None:
        return None
    if text.isdigit():
        return int(text)
    return [d.strip() for d in text.split(",") if d.strip()]


def results(reqs) -> dict:
    """The served requests' outputs, in request order: class counts,
    predictions and the telemetry's event and drop counters (the keys of
    ``tests/golden/tiny_gesture_trained_serve.npz``)."""
    tele = [r.telemetry for r in reqs]
    return {
        "uids": np.asarray([r.uid for r in reqs], np.int64),
        "class_counts": np.stack([np.asarray(r.class_counts)
                                  for r in reqs]),
        "predictions": np.asarray([r.prediction for r in reqs], np.int64),
        "per_layer_events": np.stack([np.asarray(t.per_layer_events)
                                      for t in tele]),
        "inter_layer_dropped": np.stack([np.asarray(t.inter_layer_dropped)
                                         for t in tele]),
        "input_dropped": np.asarray([t.input_dropped for t in tele],
                                    np.int64),
    }


def main(argv=None) -> dict:
    """Parse ``argv``, serve, print the table and the summary; returns the
    served outputs (:func:`results`), the engine's statistics, the
    launches and, in streaming mode, the runtime's report."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", choices=("synthetic", "file"),
                    default="synthetic")
    ap.add_argument("--file", default=None,
                    help="recording path (.npz/.aedat); default = bundled "
                    "sample (requires --source file)")
    ap.add_argument("--window-us", type=int, default=1000,
                    help="sensor time per timestep bin (file source)")
    ap.add_argument("--speedup", type=float, default=2000.0,
                    help="replay pace: sensor time / wall time (file source)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--window", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-idle-skip", action="store_true",
                    help="step every window densely (the pre-skip engine)")
    ap.add_argument("--tile-sparsity", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="skip cold spatial tiles inside the window kernels "
                    "(bitwise invisible; --no-tile-sparsity runs every tile)")
    ap.add_argument("--dtype-policy", choices=DTYPE_POLICIES,
                    default=F32_CARRIER,
                    help="datapath dtype domain; int8-native quantises the "
                    "net and serves int8 codes and storage (paper §III-D4)")
    ap.add_argument("--fusion-policy", choices=FUSION_POLICIES,
                    default=FUSED_WINDOW,
                    help="window lowering: fused-window (one launch per "
                    "layer per window, default), the per-step oracle, or "
                    "fused-network (the whole network in one launch per "
                    "window, shared memory permitting)")
    ap.add_argument("--backend", choices=BACKENDS, default=BACKEND_LOCAL,
                    help="local = one-device engine (the parity oracle); "
                    "mesh = slot axis sharded over --devices")
    ap.add_argument("--devices", default=None,
                    help="mesh: a count of cards or a comma-separated "
                    "device list, repeats allowed (default: every visible "
                    "card, or --device)")
    ap.add_argument("--weights", choices=("random", "trained"),
                    default="random",
                    help="random = init_snn(numpy seed) weights; trained = "
                    "the bundled surrogate-gradient-trained tiny-gesture "
                    "checkpoint (train.snn_loop.load_trained_tiny)")
    ap.add_argument("--mode", choices=("sync", "streaming"), default="sync",
                    help="sync = EventServeEngine.run (the parity oracle); "
                    "streaming = the double-buffered StreamingRuntime under "
                    "open-loop Poisson load")
    ap.add_argument("--arrival-rate", type=float, default=200.0,
                    help="streaming: Poisson arrival rate, requests/s")
    ap.add_argument("--queue-cap", type=int, default=16,
                    help="streaming: bounded admission queue capacity")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="streaming: per-request SLO deadline; past it a "
                    "queued request expires and a running one is evicted")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.weights == "trained":
        spec, params, meta = load_trained_tiny(device=dev)
        print(f"=== trained checkpoint: {int(meta['steps'])} steps, "
              f"eval acc {float(meta['eval_acc']):.3f}, "
              f"qat={bool(meta['qat'])} ===")
        # serve what training saw: the layer-shared int4 grid
        qn = quantize_net(params, spec, per_channel=False)
        spec, params = qn.spec, qn.params_for(args.dtype_policy)
    else:
        spec = tiny_net()
        params = [EConvParams(w=p.w.to(dev)) for p in init_snn(
            np.random.default_rng(args.seed), spec, device="cpu")]
        if args.dtype_policy == INT8_NATIVE:
            qn = quantize_net(params, spec)
            spec, params = qn.spec, qn.params_for(args.dtype_policy)
    policy = ExecutionPolicy(dtype_policy=args.dtype_policy,
                             fusion_policy=args.fusion_policy,
                             idle_skip=not args.no_idle_skip,
                             tile_sparsity=args.tile_sparsity,
                             backend=args.backend)
    if args.backend == BACKEND_LOCAL:
        if args.devices is not None:
            raise SystemExit("--devices places the shards of --backend mesh")
        eng = EventServeEngine(spec, params, n_slots=args.slots,
                               window=args.window, policy=policy, device=dev)
    else:
        devices = parse_devices(args.devices)
        if devices is None and args.device is not None:
            devices = [dev]
        eng = EventServeEngine(spec, params, n_slots=args.slots,
                               window=args.window, policy=policy,
                               devices=devices)
        print(f"=== mesh backend: {eng.D} shard(s) x {eng.spd} slot(s) on "
              f"{', '.join(str(d) for d in eng.devices)} ===")

    labels = None
    client = None
    if args.source == "file":
        path = args.file or sample_recording_path()
        rec = load_recording(path)
        reqs = segment_recording(rec, spec.in_shape, spec.n_timesteps,
                                 args.window_us)
        if args.mode == "sync":
            client = ReplayClient(reqs, spec.n_timesteps, args.window_us,
                                  speedup=args.speedup)
        print(f"=== replaying {rec.name}: {rec.n_events} events / "
              f"{rec.duration_us / 1e3:.0f} ms -> {len(reqs)} segment "
              f"requests ({args.slots} slots, window {args.window}, "
              f"mode {args.mode}, "
              f"idle_skip={'on' if eng.idle_skip else 'off'}) ===")
    else:
        spikes, labels = batch_at(args.seed, 0, args.requests, TINY,
                                  device="cpu")
        reqs = [EventRequest.from_dense(i, spikes[i])
                for i in range(args.requests)]
        print(f"=== serving {args.requests} event streams "
              f"({args.slots} slots, window {args.window}, "
              f"{args.fusion_policy} on {dev}, mode {args.mode}, "
              f"idle_skip={'on' if eng.idle_skip else 'off'}) ===")

    launches0 = sum(LAUNCHES.values())
    t0 = time.time()
    rep = None
    if args.mode == "streaming":
        rt = StreamingRuntime(eng, queue_capacity=args.queue_cap)
        lg = PoissonLoadGen(
            reqs, rate_hz=args.arrival_rate, seed=args.seed,
            slo_s=args.slo_ms / 1e3 if args.slo_ms is not None else None)
        rep = rt.serve(lg)
    elif client is not None:
        client.run(eng)
    else:
        eng.run(reqs)
    dt = time.time() - t0
    launches = sum(LAUNCHES.values()) - launches0
    if args.mode == "sync":
        assert all(r.done for r in reqs)
    reqs = [r for r in reqs if r.done]   # streaming may shed load (by SLO)

    print(f"{'req':>4} {'pred':>4} {'label':>5} {'events':>8} {'act%':>6} "
          f"{'sne_ms':>7} {'par_ms':>7} {'uJ':>7} {'drops':>5} {'skipW':>5}")
    labels = np.asarray(labels) if labels is not None else None
    for r in reqs:
        lab = labels[r.uid] if labels is not None else None
        t = r.telemetry
        print(f"{r.uid:>4} {r.prediction:>4} "
              f"{'-' if lab is None else int(lab):>5} "
              f"{t.total_events:>8.0f} {t.activity * 100:>6.2f} "
              f"{t.sne_time_s * 1e3:>7.2f} {t.sne_time_par_s * 1e3:>7.2f} "
              f"{t.sne_energy_j * 1e6:>7.2f} "
              f"{t.input_dropped + int(sum(t.inter_layer_dropped)):>5} "
              f"{t.n_skipped_windows:>5}")

    stats = dict(eng.stats)
    slot_ts = stats["windows"] * args.window * args.slots
    occ = (sum(r.n_timesteps for r in reqs) / slot_ts) if slot_ts else 0.0
    skipped = stats["skipped_slot_windows"]
    total_sw = skipped + stats["dense_slot_windows"]
    print(f"done in {dt:.2f}s wall | {stats['windows']} windows | "
          f"mean occupancy {occ:.2f} | idle-skipped {skipped}/{total_sw} "
          f"slot-windows | {stats['kernel_launches']} kernel launches "
          f"({launches} in LAUNCHES)")
    if client is not None:
        print(f"replay: slept {client.stats['slept_s']:.2f}s of "
              f"{client.stats['wall_s']:.2f}s wall "
              f"({client.stats['stalled_windows']} stalled windows)")
    if rep is not None:
        print(f"streaming: {rep['completed']} completed | "
              f"{rep['rejected_queue_full']} rejected | "
              f"{rep['expired_in_queue']} expired | "
              f"{rep['evicted_deadline']} evicted | sustained "
              f"{rep['sustained_events_per_s']:.0f} events/s")
        print(f"streaming: window p50/p99 "
              f"{rep['p50_window_latency_ms']:.2f}/"
              f"{rep['p99_window_latency_ms']:.2f} ms | e2e p99 "
              f"{rep['p99_e2e_latency_ms']:.2f} ms | mean queue depth "
              f"{rep['mean_queue_depth']:.2f} | padding waste "
              f"x{rep['padding']['padding_waste_ratio']:.2f}")
    out = {"stats": stats, "launches": launches, "wall_s": dt,
           "report": rep, "n_completed": len(reqs)}
    if reqs:
        agg = summarize([r.telemetry for r in reqs])
        r2 = proportionality_r2([r.telemetry for r in reqs])
        print(f"modeled: {agg['modeled_rate_hz']:.0f} inf/s | "
              f"{agg['mean_sne_energy_j'] * 1e6:.2f} uJ/inf | "
              f"energy-vs-events R^2 = {r2:.5f}")
        out.update(results(reqs), summary=agg, r2=r2)
    else:
        # streaming under a tight SLO can shed every request
        print("modeled: no completed requests (all load shed)")
    return out


if __name__ == "__main__":
    main()
