"""Energy-proportionality, on the paper's workload and on an assigned LM.

    PYTHONPATH=src python -m repro_torch.examples.event_sparsity [--device cpu]

Part 1 — SNE eCNN: sweep input activity, show that inference time and
energy scale linearly with the event count (paper §IV-A3, Table I band).
Part 2 — sigma-delta gated RG-LRU decode (recurrentgemma's recurrence,
the paper's TLU idea transferred): sweep the event threshold, show the
state-update activity (and the SNE model's energy) falling while the
state stays close.  The example asserts its claims: R^2 > 0.999 of energy
against events, an event fraction of 1.0 at threshold 0, and a falling
one above it.

The weights, the sample, the thinning field and the decode inputs are
made on the CPU (numpy and ``torch.Generator`` seeded from ``--seed``) and
moved, so the card and the CPU run the same inputs.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core.econv import EConvParams
from repro_torch.core.engine import SneConfig, inference_energy_j
from repro_torch.core.lm_events import (decode_energy_estimate,
                                        gated_rglru_step, sd_init)
from repro_torch.core.sne_net import (default_capacities, event_apply,
                                      init_snn, tiny_net)
from repro_torch.data.events_ds import TINY, batch_at
from repro_torch.device import resolve_device
from repro_torch.models.layers import init_tree
from repro_torch.models.recurrent import rglru_decls, rglru_step

FRACTIONS = (0.25, 0.5, 0.75, 1.0)
THRESHOLDS = (0.0, 0.05, 0.1, 0.25, 0.5)


def _on(params: Sequence[EConvParams], dev) -> List[EConvParams]:
    return [EConvParams(w=p.w.to(dev)) for p in params]


def sweep_activity(seed: int = 0, params=None, spikes=None, field=None,
                   device=None) -> List[Dict]:
    """Events, SOPs and modelled energy of ``tiny_net`` on one sample
    thinned to each of :data:`FRACTIONS` of its events.

    The thinned streams are nested: one uniform ``field`` of the sample's
    shape (default: ``numpy.random.default_rng(1)``) is thresholded at
    each fraction.  ``params`` default to ``init_snn(default_rng(seed))``,
    ``spikes`` (``(T, H, W, C)``) to the first sample of ``batch_at(seed,
    0, 4, TINY)`` drawn on the CPU; all three are moved to ``device``
    (default: CUDA)."""
    dev = resolve_device(device)
    spec = tiny_net()
    if params is None:
        params = init_snn(np.random.default_rng(seed), spec, device="cpu")
    if spikes is None:
        spikes = batch_at(seed, 0, 4, TINY, device="cpu")[0][0]
    if field is None:
        field = np.random.default_rng(1).random(tuple(spikes.shape))
    params, spikes = _on(params, dev), spikes.to(dev)
    field = torch.as_tensor(np.asarray(field), device=dev)
    caps = default_capacities(spec, activity=0.3, slack=6.0)
    cfg = SneConfig(n_slices=8)
    rows = []
    for frac in FRACTIONS:
        # thin the event stream to emulate lower sensor activity
        thinned = spikes * (field < frac).to(spikes.dtype)
        stream = ev.dense_to_events(thinned, ev.capacity_for(
            tuple(thinned.shape), 0.3, slack=4.0))
        _, stats = event_apply(params, spec, stream, caps, device=dev)
        n_ev = float(stats.total_events)
        rows.append({"activity_frac": frac, "events": n_ev,
                     "sops": float(stats.total_sops),
                     "energy_uj": inference_energy_j(cfg, n_ev) * 1e6})
    return rows


def _rglru_params(seed: int, d: int, dev) -> Dict:
    """An RG-LRU layer (width ``d``, conv width 4) drawn on the CPU from a
    ``torch.Generator`` seeded ``seed``, moved to ``dev``."""
    p = init_tree(torch.Generator().manual_seed(seed),
                  rglru_decls(d, d, 4), torch.device("cpu"))
    return {k: v.to(dev) for k, v in p.items()}


def sweep_sigma_delta(seed: int = 0, d: int = 64, steps: int = 64,
                      params: Optional[Dict] = None,
                      device=None) -> List[Dict]:
    """Mean event fraction and modelled energy per token of gated RG-LRU
    decode at each of :data:`THRESHOLDS`, on ``steps`` inputs a threshold
    (a base vector plus 0.08 noise, from ``numpy.random.default_rng(seed)``
    in the reference's order).  ``params`` default to
    :func:`_rglru_params`; on ``device`` (default: CUDA)."""
    dev = resolve_device(device)
    p = _rglru_params(seed, d, dev) if params is None else params
    rng = np.random.default_rng(seed)
    rows = []
    for th in THRESHOLDS:
        sd = sd_init(torch.zeros((1, d), device=dev))
        h = torch.zeros((1, d), dtype=torch.float32, device=dev)
        base = rng.normal(size=(1, d)).astype(np.float32)
        frac_sum = 0.0
        for _ in range(steps):
            x_t = torch.from_numpy(
                base + 0.08 * rng.normal(size=(1, d)).astype(np.float32)
            ).to(dev)
            _, h, sd, frac = gated_rglru_step(p, x_t, h, sd, th)
            frac_sum += float(frac)
        frac_mean = frac_sum / steps
        e = decode_energy_estimate(frac_mean, d, n_layers=26, n_tokens=steps)
        rows.append({"threshold": th, "event_frac": frac_mean,
                     "energy_per_token_nj": e["energy_per_token_j"] * 1e9})
    return rows


def gated_state_error(p: Dict, d: int = 128, steps: int = 96,
                      thresholds=(0.05, 0.25), seed: int = 0,
                      device=None) -> Dict[float, float]:
    """Max ``|h_gated - h_exact|`` over ``steps`` decode steps at each
    threshold, the inputs from ``numpy.random.default_rng(seed)``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(1, d)).astype(np.float32)
    out = {}
    for th in thresholds:
        h_g = h_x = torch.zeros((1, d), dtype=torch.float32, device=dev)
        sd = sd_init(torch.zeros((1, d), device=dev))
        err = 0.0
        for _ in range(steps):
            x_t = torch.from_numpy(
                base + 0.08 * rng.normal(size=(1, d)).astype(np.float32)
            ).to(dev)
            _, h_x = rglru_step(p, x_t, h_x)
            _, h_g, sd, _ = gated_rglru_step(p, x_t, h_g, sd, th)
            err = max(err, float((h_g - h_x).abs().max()))
        out[th] = err
    return out


def r_squared(xs, ys) -> float:
    """Squared Pearson correlation of ``xs`` and ``ys``."""
    return float(np.corrcoef(np.asarray(xs), np.asarray(ys))[0, 1] ** 2)


def main(argv=None) -> dict:
    """Parse ``argv``, run both parts, print them; returns their rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("=== Part 1: SNE energy ∝ events (paper §IV-A3) ===")
    rows = sweep_activity(seed=args.seed, device=dev)
    for r in rows:
        bar = "#" * int(40 * r["energy_uj"] / rows[-1]["energy_uj"])
        print(f"  activity x{r['activity_frac']:.2f}: "
              f"{r['events']:7.0f} events  {r['energy_uj']:7.2f} uJ  {bar}")
    ratio = rows[-1]["energy_uj"] / rows[0]["energy_uj"]
    ev_ratio = rows[-1]["events"] / rows[0]["events"]
    r2 = r_squared([r["events"] for r in rows],
                   [r["energy_uj"] for r in rows])
    print(f"  energy ratio {ratio:.2f} vs event ratio {ev_ratio:.2f}, "
          f"R^2 = {r2:.5f} -> proportional ✓")
    assert r2 > 0.999, r2

    print("\n=== Part 2: sigma-delta gated RG-LRU decode (TLU transfer) ===")
    sd_rows = sweep_sigma_delta(seed=args.seed, steps=96, d=128, device=dev)
    for r in sd_rows:
        bar = "#" * int(40 * r["event_frac"])
        print(f"  theta={r['threshold']:.2f}: event fraction "
              f"{r['event_frac']:.3f}  "
              f"{r['energy_per_token_nj']:8.2f} nJ/token  {bar}")
    assert sd_rows[0]["event_frac"] == 1.0
    assert sd_rows[-1]["event_frac"] < sd_rows[0]["event_frac"]

    # output-quality check: gated vs exact hidden state divergence
    errs = gated_state_error(_rglru_params(args.seed, 128, dev), seed=0,
                             device=dev)
    for th, e in errs.items():
        print(f"  theta={th:.2f}: max |h_gated - h_exact| over 96 steps = "
              f"{e:.4f}")
    print("  (small thresholds trade tiny state error for large event "
          "savings — the paper's energy-to-information proportionality)")
    return {"activity": rows, "r2": r2, "sigma_delta": sd_rows,
            "state_error": errs}


if __name__ == "__main__":
    main()
