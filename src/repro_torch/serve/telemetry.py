"""Per-request telemetry for the event-serving engine.

Counterpart of ``repro.serve.telemetry`` (pure Python, copied): maps the
event counts the engine measured through the analytic SNE model
(`core.engine`) into what the inference would cost on the ASIC.  Two
latencies per request: ``sne_time_s`` (mapping mode 2, serialised) and
``sne_time_par_s`` (mapping mode 1, layers spread over slices).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from repro_torch.core.engine import (SneConfig, boundary_time_s,
                                     inference_time_s, power_w)


@dataclasses.dataclass(frozen=True)
class RequestTelemetry:
    """What one served inference measured and what it would cost on SNE."""

    uid: int
    n_timesteps: int
    n_windows: int
    per_layer_events: Sequence[float]   # input events consumed per layer
    per_layer_sops: Sequence[float]     # synaptic updates per layer
    input_dropped: int   # ingest overflow + collector overflow + out-of-range
    inter_layer_dropped: Sequence[float]  # per-layer spike-buffer overflow
    activity: float                     # events / (total input sites x T)
    wall_time_s: float                  # host wall-clock inside the engine
    sne_time_s: float
    sne_time_par_s: float
    sne_energy_j: float
    sne_power_w: float
    n_dense_timesteps: int = 0   # timesteps actually stepped
    n_skipped_windows: int = 0   # whole windows bypassed by the idle skip

    @property
    def total_events(self) -> float:
        """Events consumed across all layers of this inference."""
        return float(sum(self.per_layer_events))

    @property
    def total_sops(self) -> float:
        """Synaptic operations across all layers of this inference."""
        return float(sum(self.per_layer_sops))


def request_telemetry(cfg: SneConfig, *, uid: int, n_timesteps: int,
                      n_windows: int,
                      per_layer_events: Sequence[float],
                      per_layer_sops: Sequence[float],
                      input_sites: int,
                      input_dropped: int = 0,
                      inter_layer_dropped: Optional[Sequence[float]] = None,
                      wall_time_s: float = 0.0,
                      n_parallel_slices: Optional[int] = None,
                      n_dense_timesteps: Optional[int] = None,
                      n_skipped_windows: int = 0) -> RequestTelemetry:
    """Build a :class:`RequestTelemetry` from measured counts.

    ``input_sites`` is ``sum_l H_l·W_l·C_l``; activity is total events over
    sites × timesteps (comparable to the paper's 1.2%–4.9% band).
    """
    total = float(sum(per_layer_events))
    act = total / max(input_sites * n_timesteps, 1)
    dense_ts = n_timesteps if n_dense_timesteps is None else n_dense_timesteps
    t_bnd = boundary_time_s(cfg, dense_ts)
    t_serial = inference_time_s(cfg, total) + t_bnd
    k = n_parallel_slices if n_parallel_slices is not None else cfg.n_slices
    t_par = inference_time_s(cfg, total, n_parallel_slices=k,
                             per_layer_events=per_layer_events) + t_bnd
    p = power_w(cfg, act)
    return RequestTelemetry(
        uid=uid,
        n_timesteps=n_timesteps,
        n_windows=n_windows,
        per_layer_events=tuple(float(e) for e in per_layer_events),
        per_layer_sops=tuple(float(s) for s in per_layer_sops),
        input_dropped=int(input_dropped),
        inter_layer_dropped=tuple(
            float(d) for d in (inter_layer_dropped or ())),
        activity=act,
        wall_time_s=float(wall_time_s),
        sne_time_s=t_serial,
        sne_time_par_s=t_par,
        sne_energy_j=p * t_serial,
        sne_power_w=p,
        n_dense_timesteps=int(dense_ts),
        n_skipped_windows=int(n_skipped_windows),
    )


def summarize(records: Sequence[RequestTelemetry]) -> Dict[str, float]:
    """Fleet-level aggregate over a batch of served requests."""
    if not records:
        return {"n_requests": 0}
    n = len(records)
    tot_ev = sum(r.total_events for r in records)
    tot_sops = sum(r.total_sops for r in records)
    tot_e = sum(r.sne_energy_j for r in records)
    tot_t = sum(r.sne_time_s for r in records)
    return {
        "n_requests": n,
        "total_events": tot_ev,
        "total_sops": tot_sops,
        "total_dropped": sum(r.input_dropped for r in records)
        + sum(sum(r.inter_layer_dropped) for r in records),
        "mean_events": tot_ev / n,
        "mean_activity": sum(r.activity for r in records) / n,
        "mean_sne_time_s": tot_t / n,
        "mean_sne_time_par_s": sum(r.sne_time_par_s for r in records) / n,
        "mean_sne_energy_j": tot_e / n,
        "energy_per_event_j": tot_e / tot_ev if tot_ev else 0.0,
        "events_per_joule": tot_ev / tot_e if tot_e else 0.0,
        "modeled_rate_hz": n / tot_t if tot_t else float("inf"),
        "total_dense_timesteps": sum(r.n_dense_timesteps for r in records),
        "total_skipped_windows": sum(r.n_skipped_windows for r in records),
    }
