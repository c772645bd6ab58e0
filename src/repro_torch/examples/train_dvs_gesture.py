"""End to end: train an event-based CNN on synthetic DVS-Gesture,
quantise it to the SNE integer domain, validate the event path, and
report Table-I-style energy and throughput from the event counts.

    PYTHONPATH=src python -m repro_torch.examples.train_dvs_gesture \\
        [--steps 300] [--scale tiny|nmnist|full] [--qat] \\
        [--mix-recording] [--save-net out.npz] [--device cpu]

``tiny`` (default) suits the CPU; ``nmnist`` and ``full`` use the paper's
geometries (``full`` = the Fig. 6 IBM DVS-Gesture network, 128x128x2,
T = 100).  Training runs through `train.snn_loop.fit`: surrogate
gradients over the compiled layer program's dense twin, optional 4-bit
QAT.  ``--mix-recording`` folds windows of the bundled DVS sample into
each batch; ``--save-net`` writes the single-file ``.npz`` artifact that
both packages' ``load_net`` read.  The held-out samples then go through
the dense forward and, quantised with ``quantize_net(per_channel=False)``,
through the event path (``event_predict``, the N = 1 faces of the
per-step scatter kernels on the card).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core.engine import (SneConfig, inference_energy_j,
                                     inference_rate_hz)
from repro_torch.core.quant import quantize_net
from repro_torch.core.sne_net import (default_capacities, dense_apply,
                                      dvs_gesture_net, event_predict,
                                      nmnist_net, predict, tiny_net)
from repro_torch.data.events_ds import (DVS_GESTURE, NMNIST, TINY, batch_at,
                                        load_recording,
                                        recording_dense_windows,
                                        sample_recording_path)
from repro_torch.device import resolve_device
from repro_torch.train.snn_loop import TrainConfig, evaluate, fit, save_net


def get_setup(scale: str):
    """``(SNNSpec, EventDatasetSpec)`` of a ``--scale``."""
    if scale == "tiny":
        return tiny_net(), TINY
    if scale == "nmnist":
        return nmnist_net(), NMNIST
    return dvs_gesture_net(), DVS_GESTURE


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Parse ``argv``, train, evaluate both paths, print them; returns the
    losses, step times, accuracies, event counts and drops."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--scale", default="tiny",
                    choices=("tiny", "nmnist", "full"))
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--test-n", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--qat", action="store_true",
                    help="straight-through int4 fake-quant during training")
    ap.add_argument("--mix-recording", action="store_true",
                    help="mix bundled-recording windows into each batch "
                         "(tiny scale only)")
    ap.add_argument("--save-net", default="",
                    help="write the trained net as a single .npz artifact")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    spec, ds = get_setup(args.scale)
    cfg = TrainConfig(steps=args.steps, batch=args.batch, lr=args.lr,
                      seed=args.seed, qat=args.qat)

    recording = None
    if args.mix_recording:
        if args.scale != "tiny":
            raise SystemExit("--mix-recording needs --scale tiny (the "
                             "bundled sample is 12x12)")
        rec = load_recording(sample_recording_path())
        recording = recording_dense_windows(rec, spec.in_shape,
                                            spec.n_timesteps, 1000)
        print(f"mixing {int(recording[0].shape[0])} recording windows "
              f"(label {rec.label}) into training batches")

    result = fit(spec, ds, cfg, ckpt_dir=args.ckpt_dir or None,
                 ckpt_every=100, recording=recording, log_every=25,
                 device=dev)
    params = result.params
    print(f"trained {cfg.steps - result.start_step} steps in "
          f"{result.wall_time_s:.0f}s, final loss {result.losses[-1]:.4f}")

    acc = evaluate(spec, params, ds, n=args.test_n, seed=args.seed + 1,
                   qat=args.qat, device=dev)
    print(f"eval accuracy (program forward): {acc:.3f}")

    if args.save_net:
        save_net(args.save_net, params,
                 meta={"steps": cfg.steps, "seed": cfg.seed,
                       "qat": int(cfg.qat), "loss": result.losses[-1],
                       "eval_acc": acc, "scale": args.scale})
        print(f"saved trained net -> {args.save_net}")

    # --- evaluation: QAT dense vs SNE-quantised event path ---
    spikes, labels = batch_at(args.seed + 1, 10**6, args.test_n, ds,
                              device=dev)
    qnet = quantize_net(params, spec, per_channel=False)
    qp, qspec = qnet.params_for("f32-carrier"), qnet.spec
    caps = default_capacities(qspec, activity=0.2, slack=6.0)
    acc_dense = acc_event = agree = 0
    total_events = 0.0
    layer_drops = np.zeros(len(spec.layers), np.int64)
    input_drops = 0
    event_s = []
    for i in range(args.test_n):
        with torch.no_grad():
            out, _ = dense_apply(params, spec, spikes[i], qat=args.qat)
        pd = int(predict(out))
        cap = ev.capacity_for(tuple(spikes[i].shape), 0.3, slack=4.0)
        input_drops += ev.overflow_count(spikes[i], cap)
        _sync(dev)
        t0 = time.perf_counter()
        stream = ev.dense_to_events(spikes[i], cap)
        pe, _, stats = event_predict(qp, qspec, stream, caps, device=dev)
        pe = int(pe)
        event_s.append(time.perf_counter() - t0)
        acc_dense += pd == int(labels[i])
        acc_event += pe == int(labels[i])
        agree += pe == pd
        total_events += float(stats.total_events)
        layer_drops += np.asarray([int(s.n_dropped) for s in stats.per_layer])
    n = args.test_n
    print(f"\naccuracy: dense={acc_dense / n:.3f}  "
          f"event(SNE int domain)={acc_event / n:.3f}  "
          f"path agreement={agree / n:.3f}")
    print(f"event path: {1e3 * float(np.median(event_s)):.1f} ms/inference "
          f"(p50 of {n}) on {dev} | dropped: input {input_drops}, "
          f"per layer {layer_drops.tolist()}")

    cfg_hw = SneConfig(n_slices=8)
    mean_ev = total_events / n
    print(f"mean events/inference: {mean_ev:.0f}")
    print(f"SNE energy: {inference_energy_j(cfg_hw, mean_ev) * 1e6:.2f} "
          f"uJ/inf, rate: {inference_rate_hz(cfg_hw, mean_ev):.0f} inf/s "
          f"(paper Table I @DVS-Gesture: 80-261 uJ/inf, 141-43 inf/s)")
    return {"losses": result.losses, "step_s": result.step_s,
            "start_step": result.start_step, "eval_acc": acc,
            "acc_dense": acc_dense / n, "acc_event": acc_event / n,
            "agreement": agree / n, "mean_events": mean_ev,
            "event_ms": 1e3 * np.asarray(event_s),
            "input_dropped": input_drops,
            "layer_dropped": layer_drops.tolist(), "params": params}


if __name__ == "__main__":
    main()
