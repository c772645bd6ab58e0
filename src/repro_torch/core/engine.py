"""SNE hardware model — the analytic twin of the ASIC (paper §III-D, §IV).

Counterpart of the parts of ``repro.core.engine`` the serving telemetry
uses: the macro-architecture parameters, the calibrated power model and
the event-time mapping.  Pure Python, copied so the port imports nothing
of the reference package.

Calibration anchors (paper text): 1 SOP per cluster per cycle, 16
clusters per slice, 48 cycles per input event at 400 MHz, 11.29 mW at 8
slices.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class SneConfig:
    """The SNE macro-architecture parameters (paper §III-D / §IV-A)."""

    n_slices: int = 8
    clusters_per_slice: int = 16
    tdm_neurons: int = 64           # neurons per cluster (time-multiplexed)
    freq_hz: float = 400e6
    cycles_per_event: int = 48      # paper §IV-A3
    weight_bits: int = 4
    state_bits: int = 8
    weight_buffer_sets: int = 256   # on-the-fly selectable filter sets
    supply_v: float = 0.8
    # cycles charged per processed timestep boundary (0 keeps the paper
    # calibration, where the 48-cycle event cost amortises sequencing)
    cycles_per_boundary: int = 0


_P_FIXED_W = 1.0e-3            # DMAs + collector + C-XBAR base
_P_PER_SLICE_W = (11.29e-3 - _P_FIXED_W) / 8.0   # = 1.28625 mW / slice


def power_w(cfg: SneConfig, activity: float = 0.05) -> float:
    """Average modelled power; the slice share scales with activity
    around the 5% calibration point."""
    act_scale = 0.2 + 0.8 * min(activity / 0.05, 1.0)
    return _P_FIXED_W + cfg.n_slices * _P_PER_SLICE_W * act_scale


def time_per_event_s(cfg: SneConfig) -> float:
    """An input event is consumed in ``cycles_per_event`` cycles."""
    return cfg.cycles_per_event / cfg.freq_hz


def boundary_time_s(cfg: SneConfig, n_boundaries: float) -> float:
    """Sequencer cost of ``n_boundaries`` processed timestep boundaries."""
    return n_boundaries * cfg.cycles_per_boundary / cfg.freq_hz


def inference_time_s(cfg: SneConfig, total_events: float,
                     n_parallel_slices: int | None = None,
                     per_layer_events: Sequence[float] | None = None) -> float:
    """Modelled inference latency from measured event counts.

    ``n_parallel_slices=None``: mapping mode 2 (the whole stream through
    one slice).  With ``k`` slices and per-layer counts: mapping mode 1
    (greedy longest-first layer assignment; the busiest slice is the
    critical path).  With ``k`` but no counts: the ideal ``total / k``.
    """
    tpe = time_per_event_s(cfg)
    if n_parallel_slices is None:
        if per_layer_events is not None:
            raise ValueError("per_layer_events given without "
                             "n_parallel_slices — pass k to get mapping "
                             "mode 1, or drop the layer counts for mode 2")
        return total_events * tpe
    if n_parallel_slices < 1:
        raise ValueError(f"n_parallel_slices={n_parallel_slices} < 1")
    k = min(n_parallel_slices, cfg.n_slices)
    if per_layer_events is None:
        return total_events / k * tpe
    layer_sum = sum(per_layer_events)
    if abs(layer_sum - total_events) > 1e-6 * max(1.0, total_events):
        raise ValueError(
            f"per_layer_events sums to {layer_sum}, inconsistent with "
            f"total_events={total_events}")
    loads = [0.0] * k
    for ev_n in sorted(per_layer_events, reverse=True):
        loads[loads.index(min(loads))] += ev_n
    return max(loads) * tpe
