"""Quickstart: the SNE execution model in five minutes.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds a tiny event-based CNN, runs the same network through the dense
(frame-based) path and the SNE event path, checks that they agree
exactly, and maps the event counts onto the paper's silicon energy model.
The weights (``numpy.random.default_rng(--seed)``) and the sample
(``batch_at`` on the CPU) are made on the CPU and moved, so the card and
the CPU run the same inputs.
"""
from __future__ import annotations

import argparse
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core.econv import EConvParams
from repro_torch.core.engine import (SneConfig, energy_per_sop_j,
                                     inference_energy_j, inference_rate_hz,
                                     inference_time_s)
from repro_torch.core.sne_net import (SNNSpec, default_capacities,
                                      dense_apply, event_predict, init_snn,
                                      predict, tiny_net)
from repro_torch.data.events_ds import TINY, batch_at
from repro_torch.device import resolve_device


def run(params: Sequence[EConvParams], spec: SNNSpec, spikes: torch.Tensor,
        device) -> dict:
    """The dense path and the event path of ``params`` on one ``(T, H, W,
    C)`` sample, on ``device`` (where ``params`` and ``spikes`` lie);
    asserts that their class counts are bitwise equal and returns them
    with the event counters."""
    out_dense, _ = dense_apply(params, spec, spikes)
    stream = ev.dense_to_events(
        spikes, ev.capacity_for(tuple(spikes.shape), 0.3, slack=4.0))
    caps = default_capacities(spec, activity=0.2, slack=6.0)
    pred_event, counts, stats = event_predict(params, spec, stream, caps,
                                              device=device)
    counts_dense = out_dense.sum(0).reshape(-1)
    if not torch.equal(counts, counts_dense):
        raise AssertionError("event path must equal dense path bit for bit")
    return {"pred_dense": int(predict(out_dense)),
            "pred_event": int(pred_event),
            "class_counts": counts.cpu().numpy(),
            "total_events": float(stats.total_events),
            "total_sops": float(stats.total_sops)}


def main(argv=None) -> dict:
    """Parse ``argv``, run the quickstart, print it; returns its numbers."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("=== SNE quickstart ===")
    spec = tiny_net()
    params = [EConvParams(w=p.w.to(dev)) for p in
              init_snn(np.random.default_rng(args.seed), spec, device="cpu")]
    print(f"network: {len(spec.layers)} layers, "
          f"{spec.n_timesteps} timesteps, input {spec.in_shape}")

    # one synthetic DVS sample (class-conditional moving-blob events)
    spikes, label = batch_at(seed=args.seed, index=0, batch_size=1,
                             spec=TINY, device="cpu")
    spikes = spikes[0].to(dev)
    activity = float(ev.activity(spikes))
    print(f"sample: label={int(label[0])}, activity={100 * activity:.2f}% "
          f"({int(spikes.sum())} events)")

    out = run(params, spec, spikes, dev)
    print(f"dense path prediction: {out['pred_dense']} | "
          f"event path prediction: {out['pred_event']}  (must agree)")
    print("event path == dense path: OK")

    # energy-proportional accounting on the paper's 8-slice engine
    cfg = SneConfig(n_slices=8)
    n_events = out["total_events"]
    out.update(label=int(label[0]), activity=activity,
               sne_time_s=inference_time_s(cfg, n_events),
               sne_energy_j=inference_energy_j(cfg, n_events),
               sne_rate_hz=inference_rate_hz(cfg, n_events),
               energy_per_sop_j=energy_per_sop_j(cfg))
    print(f"\nevents consumed across the network: {n_events:.0f} "
          f"(SOPs: {out['total_sops']:.0f})")
    print(f"SNE @400MHz: {out['sne_time_s'] * 1e6:.1f} us/inf, "
          f"{out['sne_energy_j'] * 1e9:.1f} nJ/inf, "
          f"{out['sne_rate_hz']:.0f} inf/s")
    print(f"energy/SOP: {out['energy_per_sop_j'] * 1e12:.3f} pJ "
          f"(paper: 0.221 pJ/SOP)")
    return out


if __name__ == "__main__":
    main()
