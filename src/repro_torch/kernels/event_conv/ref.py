"""Plain PyTorch version of the slot-batched event-conv scatter.

Counterpart of ``repro.kernels.event_conv.ref.event_conv_batched_ref`` and
the twin of ``csrc/event_conv.cu``: for every slot and every event, in
event order, add the event's flipped ``K x K x Co`` weight patch times its
gate into the halo-padded slab at origin ``(x, y)``:

    out[n, x + i, y + j, :] += W_flipped[i, j, c, :] * gate[n, e]

A Python loop over events, vectorised over slots; each step adds one
patch per slot, so per-site accumulation order is the event order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._common import last_active
from repro_torch.kernels.window_common import fused_window_ref


def event_conv_batched_ref(v: torch.Tensor, weights: torch.Tensor,
                           ev_xyc: torch.Tensor, ev_gate: torch.Tensor,
                           out_dtype=None) -> torch.Tensor:
    """Scatter N slots' event batches into N membrane slabs.

    Args:
      v:        (N, Hp, Wp, Co) halo-padded membranes, one per slot.
      weights:  (K, K, Ci, Co) conv weights (unflipped, HWIO).
      ev_xyc:   (N, E, 3) int32 events ``(x, y, c)`` in halo coordinates.
      ev_gate:  (N, E) gates; 0 disables an event (padding).
      out_dtype: accumulator/result dtype (default ``v.dtype``).

    Origins are clamped into the slab like ``lax.dynamic_slice`` clamps.
    """
    acc = v.dtype if out_dtype is None else out_dtype
    out = v.to(acc, copy=True)
    g = ev_gate.to(acc)
    N, Hp, Wp, _ = v.shape
    K, _, Ci, _ = weights.shape
    w_f = torch.flip(weights, (0, 1))
    x = ev_xyc[..., 0].long().clamp(0, Hp - K)
    y = ev_xyc[..., 1].long().clamp(0, Wp - K)
    c = ev_xyc[..., 2].long().clamp(0, Ci - 1)
    ar = torch.arange(K, device=v.device)
    nidx = torch.arange(N, device=v.device)[:, None, None]
    for e in range(last_active(ev_gate)):
        patch = (w_f[:, :, c[:, e], :].permute(2, 0, 1, 3)
                 * g[:, e, None, None, None]).to(acc)            # (N,K,K,Co)
        X = (x[:, e, None, None] + ar[None, :, None]).expand(N, K, K)
        Y = (y[:, e, None, None] + ar[None, None, :]).expand(N, K, K)
        out[nidx, X, Y] = out[nidx, X, Y] + patch
    return out


def event_conv_ref(v: torch.Tensor, weights: torch.Tensor,
                   ev_xyc: torch.Tensor, ev_gate: torch.Tensor,
                   out_dtype=None) -> torch.Tensor:
    """The single-stream face: :func:`event_conv_batched_ref` at N = 1 on
    one ``(Hp, Wp, Co)`` slab, ``(E, 3)`` events and ``(E,)`` gates."""
    return event_conv_batched_ref(v[None], weights, ev_xyc[None],
                                  ev_gate[None], out_dtype)[0]


def event_conv_window_ref(v: torch.Tensor, weights: torch.Tensor,
                          ev_xyc: torch.Tensor, ev_gate: torch.Tensor,
                          alive: torch.Tensor, *, lif, halo: int,
                          native: bool = False, tiles=None):
    """A whole T-timestep window of a conv layer for N slots.

    Counterpart of ``repro.kernels.event_conv.ref.event_conv_window_ref``
    and the twin of ``csrc/event_conv_window.cu``: per timestep ``leak ->
    scatter -> clip -> fire -> reset`` (`window_common.fused_window_ref`)
    with :func:`event_conv_batched_ref` as the scatter.

    Args:
      v:       (N, Hp, Wp, Co) halo-padded membranes, storage dtype.
      weights: (K, K, Ci, Co) conv weights (unflipped).
      ev_xyc:  (N, T, E, 3) int32 window schedule in halo coordinates.
      ev_gate: (N, T, E) gates.
      alive:   (N, T) per-timestep liveness.
      lif, halo, native: LIF plan, halo width, int8-native policy.
      tiles:   optional (N, nTx, nTy) interior tile bitmap.

    Returns ``(v_out, spikes (N, T, Ho, Wo, Co))``.
    """
    def scatter(acc, xyc, gate):
        return event_conv_batched_ref(acc, weights, xyc, gate)

    return fused_window_ref(v, ev_xyc, ev_gate, alive, scatter, lif=lif,
                            halo=halo, native=native, tiles=tiles)
