"""SNE hardware model — the analytic twin of the ASIC (paper §III-D, §IV).

Counterpart of ``repro.core.engine``: the macro-architecture parameters,
the calibrated power and area models, the event-time mapping and the
network-level accounting behind the paper's Figs. 4/5 and Tables I/II.
Pure Python, copied so the port imports nothing of the reference package.

Calibration anchors (paper text): 1 SOP per cluster per cycle, 16
clusters per slice, 48 cycles per input event at 400 MHz, 11.29 mW at 8
slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple


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

    @property
    def n_neurons(self) -> int:
        """Total neurons the engine time-multiplexes."""
        return self.n_slices * self.clusters_per_slice * self.tdm_neurons

    @property
    def sops_per_cycle(self) -> int:
        """Peak synaptic updates per clock."""
        # every cluster updates one TDM neuron per cycle
        return self.n_slices * self.clusters_per_slice


_P_FIXED_W = 1.0e-3            # DMAs + collector + C-XBAR base
_P_PER_SLICE_W = (11.29e-3 - _P_FIXED_W) / 8.0   # = 1.28625 mW / slice

# area model (kGE; Fig. 4 trend): ~100 GE per neuron with its share of the
# cluster datapath, fixed DMAs, a C-XBAR growing per port
_GE_PER_NEURON = 100.0
_A_DMA_KGE = 30.0              # fixed: 2 DMAs + streamers
_A_XBAR_BASE_KGE = 8.0         # C-XBAR base + per-port growth
_A_XBAR_PORT_KGE = 4.0


def power_w(cfg: SneConfig, activity: float = 0.05) -> float:
    """Average modelled power; the slice share scales with activity
    around the 5% calibration point."""
    act_scale = 0.2 + 0.8 * min(activity / 0.05, 1.0)
    return _P_FIXED_W + cfg.n_slices * _P_PER_SLICE_W * act_scale


def peak_sops(cfg: SneConfig) -> float:
    """Peak synaptic operations per second (Fig. 5b)."""
    return cfg.sops_per_cycle * cfg.freq_hz


def energy_per_sop_j(cfg: SneConfig, activity: float = 0.05) -> float:
    """Energy per synaptic operation (Fig. 5b: 0.221 pJ/SOP @ 8 slices)."""
    return power_w(cfg, activity) / peak_sops(cfg)


def efficiency_tsops_w(cfg: SneConfig, activity: float = 0.05) -> float:
    """Energy efficiency in TSOP/s/W (the paper's 4.5 headline figure)."""
    return peak_sops(cfg) / power_w(cfg, activity) / 1e12


def area_kge(cfg: SneConfig) -> Dict[str, float]:
    """Area breakdown in kGE (Fig. 4)."""
    sl = cfg.n_slices * cfg.clusters_per_slice * cfg.tdm_neurons \
        * _GE_PER_NEURON / 1e3
    xbar = _A_XBAR_BASE_KGE + _A_XBAR_PORT_KGE * cfg.n_slices
    out = {"slices": sl, "c_xbar": xbar, "dma": _A_DMA_KGE}
    out["total"] = sum(out.values())
    return out


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


def inference_energy_j(cfg: SneConfig, total_events: float,
                       activity: float = 0.05) -> float:
    """Energy is mapping-invariant: the same events trigger the same SOPs
    at ~0.221 pJ/SOP whether layers run serial or slice-parallel, so this
    is always power x *serial* time. Parallel mapping shortens latency
    (see :func:`inference_time_s`), it does not cut energy."""
    return power_w(cfg, activity) * inference_time_s(cfg, total_events)


def inference_rate_hz(cfg: SneConfig, total_events: float) -> float:
    """Modeled inferences per second at this event count."""
    return 1.0 / inference_time_s(cfg, total_events)


# ---------------------------------------------------------------------------
# Network-level accounting: map per-layer event counts (measured by the
# serving engine, or analytic from activity fractions) to Table I.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerActivity:
    """One layer's measured (or analytic) event/SOP/neuron counts."""

    name: str
    n_events: float          # input events consumed by this layer
    n_sops: float            # synaptic updates triggered
    n_neurons: int           # output neurons


def network_events_from_activity(layer_sizes: Sequence[Tuple[str, int, int]],
                                 activity: float,
                                 n_timesteps: int) -> List[LayerActivity]:
    """Analytic event counts: every layer sees `activity` fraction of its
    input tensor as events per inference (the paper reports 1.2%-4.9%
    average network activity on DVS-Gesture)."""
    out = []
    for name, in_size, fan_out in layer_sizes:
        n_ev = in_size * n_timesteps * activity
        out.append(LayerActivity(name, n_ev, n_ev * fan_out, in_size))
    return out


def summarize_inference(cfg: SneConfig, layers: Sequence[LayerActivity],
                        activity: float = 0.05) -> Dict[str, float]:
    """Map per-layer counts to the Table-I row (time/energy/power)."""
    total_events = sum(l.n_events for l in layers)
    total_sops = sum(l.n_sops for l in layers)
    t = inference_time_s(cfg, total_events)
    p = power_w(cfg, activity)
    return {
        "total_events": total_events,
        "total_sops": total_sops,
        "inference_time_s": t,
        "inference_energy_j": p * t,
        "inference_rate_hz": 1.0 / t,
        "power_w": p,
        "energy_per_sop_j": energy_per_sop_j(cfg, activity),
        "peak_sops": peak_sops(cfg),
        "efficiency_tsops_w": efficiency_tsops_w(cfg, activity),
    }


def slices_required(n_neurons: int, cfg: SneConfig) -> int:
    """Slices needed to map a layer fully spatially (mapping mode 1)."""
    per_slice = cfg.clusters_per_slice * cfg.tdm_neurons
    return math.ceil(n_neurons / per_slice)


# Published Table II rows (for the SoA-comparison benchmark).
SOA_TABLE = [
    # name, tech, perf GOP/s, eff TOP/s/W, energy/SOP pJ, freq MHz, power mW
    ("SNE (this work)", "Digital 22nm", 51.2, 4.54, 0.221, 400.0, 11.29),
    ("Tianjic", "Digital 28nm", 649.0, 1.28, 6.18, 300.0, 950.0),
    ("Dynapsel", "Analog 28nm", None, 0.6, 2.0, None, None),
    ("ODIN", "Digital 28nm", 0.038, 0.079, 12.7, 75.0, 0.477),
    ("TrueNorth", "Digital 28nm", 58.0, 0.046, 27.0, None, 65.0),
    ("SPOON", "Digital 28nm", None, None, 1700.0, 150.0, None),
    ("Loihi", "Digital 14nm", None, None, 23.0, None, None),
    ("SpiNNaker 2", "Digital 22nm", None, 3.26, 1700.0, 200.0, None),
]
