"""Plain PyTorch version of the slot-batched event sum-pool scatter.

Counterpart of ``repro.kernels.event_pool.ref.event_pool_batched_ref`` and
the twin of ``csrc/event_pool.cu``: each event adds ``w[c] * gate`` to its
one pooled site, in event order,

    out[n, x // s, y // s, c] += w[c] * gate[n, e]

and an event whose pooled site lies past the grid is dropped (the VALID
rule).  No other site is written.  A Python loop over events, vectorised
over slots.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._common import last_active
from repro_torch.kernels.window_common import fused_window_ref


def event_pool_batched_ref(v: torch.Tensor, w: torch.Tensor,
                           ev_xyc: torch.Tensor, ev_gate: torch.Tensor,
                           stride: int, out_dtype=None) -> torch.Tensor:
    """Scatter N slots' pooled event batches into N slabs.

    Args:
      v:        (N, Ho, Wo, C) membranes (pool layers have no halo).
      w:        (C,) per-channel synapse weights.
      ev_xyc:   (N, E, 3) int32 events in input coordinates.
      ev_gate:  (N, E) gates; 0 disables an event.
      stride:   pooling stride.
      out_dtype: accumulator/result dtype (default ``v.dtype``).
    """
    acc = v.dtype if out_dtype is None else out_dtype
    N, Ho, Wo, C = v.shape
    S = Ho * Wo * C
    # one trash column past the slab takes every dropped event
    buf = torch.zeros((N, S + 1), dtype=acc, device=v.device)
    buf[:, :S] = v.reshape(N, S).to(acc)
    x, y, c = (ev_xyc[..., k].long() for k in range(3))
    xo = torch.div(x, stride, rounding_mode="floor")
    yo = torch.div(y, stride, rounding_mode="floor")
    ok = ((x >= 0) & (y >= 0) & (xo < Ho) & (yo < Wo) & (c >= 0) & (c < C))
    site = torch.where(ok, (xo * Wo + yo) * C + c, torch.full_like(x, S))
    val = (w[c.clamp(0, C - 1)] * ev_gate.to(acc)).to(acc)          # (N, E)
    ar = torch.arange(N, device=v.device)
    for e in range(last_active(ev_gate)):
        buf[ar, site[:, e]] = buf[ar, site[:, e]] + val[:, e]
    return buf[:, :S].reshape(v.shape)


def event_pool_ref(v: torch.Tensor, w: torch.Tensor, ev_xyc: torch.Tensor,
                   ev_gate: torch.Tensor, stride: int,
                   out_dtype=None) -> torch.Tensor:
    """The single-stream face: :func:`event_pool_batched_ref` at N = 1 on
    one ``(Ho, Wo, C)`` slab, ``(E, 3)`` events and ``(E,)`` gates."""
    return event_pool_batched_ref(v[None], w, ev_xyc[None], ev_gate[None],
                                  stride, out_dtype)[0]


def event_pool_window_ref(v: torch.Tensor, w: torch.Tensor,
                          ev_xyc: torch.Tensor, ev_gate: torch.Tensor,
                          alive: torch.Tensor, *, lif, stride: int,
                          native: bool = False, tiles=None):
    """A whole T-timestep window of a pool layer for N slots.

    Counterpart of ``repro.kernels.event_pool.ref.event_pool_window_ref``
    and the twin of ``csrc/event_pool_window.cu``: the
    `window_common.fused_window_ref` sequence with
    :func:`event_pool_batched_ref` as the scatter.

    Args:
      v:       (N, Ho, Wo, C) membranes, storage dtype.
      w:       (C,) per-channel weights.
      ev_xyc:  (N, T, E, 3) int32 window schedule, input coordinates.
      ev_gate: (N, T, E) gates.
      alive:   (N, T) per-timestep liveness.
      lif, stride, native: LIF plan, pooling stride, int8-native policy.
      tiles:   optional (N, nTx, nTy) tile bitmap over (Ho, Wo).

    Returns ``(v_out, spikes (N, T, Ho, Wo, C))``.
    """
    def scatter(acc, xyc, gate):
        return event_pool_batched_ref(acc, w, xyc, gate, stride)

    return fused_window_ref(v, ev_xyc, ev_gate, alive, scatter, lif=lif,
                            halo=0, native=native, tiles=tiles)
