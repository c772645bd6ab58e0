"""Plain PyTorch version of the slot-batched event FC row-gather.

Counterpart of ``repro.kernels.event_fc.ref.event_fc_batched_ref`` and the
twin of ``csrc/event_fc.cu``: each event selects the weight row of its
flattened input coordinate and adds it, gated, to the output vector, in
event order,

    out[n, 0, 0, :] += W[(x * W_in + y) * C + c, :] * gate[n, e]

Events whose row lies outside ``[0, Din)`` contribute nothing.  A Python
loop over events, vectorised over slots.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels._common import last_active
from repro_torch.kernels.window_common import fused_window_ref


def event_fc_batched_ref(v: torch.Tensor, w: torch.Tensor,
                         ev_xyc: torch.Tensor, ev_gate: torch.Tensor,
                         in_shape: Tuple[int, int, int],
                         out_dtype=None) -> torch.Tensor:
    """Accumulate N slots' FC event batches into N output vectors.

    Args:
      v:        (N, 1, 1, Dout) membranes.
      w:        (Din, Dout) weights, ``Din == H * W * C``.
      ev_xyc:   (N, E, 3) int32 events in input coordinates.
      ev_gate:  (N, E) gates; 0 disables an event.
      in_shape: (H, W, C) input geometry (the flattening rule).
      out_dtype: accumulator/result dtype (default ``v.dtype``).
    """
    _, Wi, Ci = in_shape
    acc = v.dtype if out_dtype is None else out_dtype
    N, Dout = v.shape[0], v.shape[-1]
    Din = w.shape[0]
    out = v.reshape(N, Dout).to(acc, copy=True)
    row = (ev_xyc[..., 0].long() * Wi + ev_xyc[..., 1].long()) * Ci \
        + ev_xyc[..., 2].long()
    ok = (row >= 0) & (row < Din)
    g = torch.where(ok, ev_gate.to(acc), torch.zeros_like(ev_gate, dtype=acc))
    row = row.clamp(0, Din - 1)
    for e in range(last_active(g)):
        out = out + (w[row[:, e]] * g[:, e, None]).to(acc)
    return out.reshape(v.shape)


def event_fc_ref(v: torch.Tensor, w: torch.Tensor, ev_xyc: torch.Tensor,
                 ev_gate: torch.Tensor, in_shape: Tuple[int, int, int],
                 out_dtype=None) -> torch.Tensor:
    """The single-stream face: :func:`event_fc_batched_ref` at N = 1 on
    one ``(1, 1, Dout)`` slab, ``(E, 3)`` events and ``(E,)`` gates."""
    return event_fc_batched_ref(v[None], w, ev_xyc[None], ev_gate[None],
                                in_shape, out_dtype)[0]


def event_fc_window_ref(v: torch.Tensor, w: torch.Tensor,
                        ev_xyc: torch.Tensor, ev_gate: torch.Tensor,
                        alive: torch.Tensor, *, lif,
                        in_shape: Tuple[int, int, int],
                        native: bool = False):
    """A whole T-timestep window of an fc layer for N slots.

    Counterpart of ``repro.kernels.event_fc.ref.event_fc_window_ref`` and
    the twin of ``csrc/event_fc_window.cu``: the
    `window_common.fused_window_ref` sequence with
    :func:`event_fc_batched_ref` as the scatter (fc takes no tile bitmap).

    Args:
      v:        (N, 1, 1, Dout) membranes, storage dtype.
      w:        (Din, Dout) weights.
      ev_xyc:   (N, T, E, 3) int32 window schedule, input coordinates.
      ev_gate:  (N, T, E) gates.
      alive:    (N, T) per-timestep liveness.
      lif, in_shape, native: LIF plan, input geometry, int8-native policy.

    Returns ``(v_out, spikes (N, T, 1, 1, Dout))``.
    """
    def scatter(acc, xyc, gate):
        return event_fc_batched_ref(acc, w, xyc, gate, in_shape)

    return fused_window_ref(v, ev_xyc, ev_gate, alive, scatter, lif=lif,
                            halo=0, native=native)
