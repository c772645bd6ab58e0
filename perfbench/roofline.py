"""Peaks of one NVIDIA H100 SXM (data sheet, dense, 700 W) and the least
time a piece of work can take on it: the larger of its bytes over the
memory rate and its operations over the float32 rate (as
``chip_smoke.py``'s ``_bound_of``).

The serving work of an engine window is counted from the reference's
events for the requests the window served, never from the port's
counters: per layer, each stepping slot's membranes read and written once,
the weights read once (an fc layer only the rows its events name, at
least those of its busiest slot), each input and output event moved once
as a packed 32-bit word (the paper's Fig. 1 format), and one add per
neuron update an input event makes.  The count stays the same whatever
implements the layer.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

from perfbench.reference.ecnn import (state_sites, updates_per_event,
                                      weight_elems)

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
WORD = 4            # bytes of a float32 membrane, weight or packed event


def bound_s(nbytes: float, ops: float) -> float:
    """Least seconds for ``nbytes`` of memory traffic and ``ops``
    float32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def window_layer_work(layers: Sequence[dict], ref: dict, window: int,
                      slots: Iterable[Tuple[int, int, int]]):
    """``[(bytes, ops)]`` per layer for one launched engine window whose
    stepping slots are ``(recording, first timestep, alive timesteps)``."""
    slots = np.asarray(list(slots), np.int64).reshape(-1, 3)
    pid, tau, n = slots.T
    # events of each layer up to each timestep, one extra row for the
    # last layer's output events
    cum = _cumulative(ref)
    out = []
    for l, layer in enumerate(layers):
        ev_in = float((cum[pid, l, tau + n] - cum[pid, l, tau]).sum())
        ev_out = float((cum[pid, l + 1, tau + n]
                        - cum[pid, l + 1, tau]).sum())
        if layer["kind"] == "fc":
            rows = float(ref["distinct"][pid, l, tau // window].max(
                initial=0))
            w_bytes = rows * layer["out_shape"][2] * WORD
        else:
            w_bytes = weight_elems(layer) * WORD
        nbytes = (2 * len(pid) * state_sites(layer) * WORD + w_bytes
                  + WORD * (ev_in + ev_out))
        out.append((nbytes, ev_in * updates_per_event(layer)))
    return out


def _cumulative(ref: dict) -> np.ndarray:
    """``(R, L + 1, T + 1)`` running sums of the events entering each
    layer (and leaving the last)."""
    ev = np.concatenate([ref["events"], ref["out_events"][:, None]], 1)
    return np.concatenate([np.zeros(ev.shape[:2] + (1,), np.int64),
                           np.cumsum(ev, axis=2, dtype=np.int64)], 2)


def serving_bound_s(layers, ref, window, launches) -> float:
    """Least device seconds of the window kernels of ``launches``
    (``[(time, [(recording, tau, alive, events)])]``): one launch per
    layer and window, each bounded alone."""
    return sum(bound_s(b, o) for _, work in launches
               for b, o in window_layer_work(
                   layers, ref, window, [w[:3] for w in work]))


def serving_ops(layers, ref, window, launches) -> float:
    """Useful synaptic operations of ``launches``: events into each layer
    times the updates each makes."""
    return sum(o for _, work in launches
               for _, o in window_layer_work(layers, ref, window,
                                             [w[:3] for w in work]))
