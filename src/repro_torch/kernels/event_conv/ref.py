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


def selfcheck_batched_bitexact(N: int, H: int, W: int, Co: int, K: int,
                               Ci: int, E: int, seed: int = 0,
                               device=None) -> None:
    """Assert the batched scatter == its N = 1 face slot by slot == the
    plain version, bit for bit; raises AssertionError on any mismatch.

    The one statement of the equivalence contract.  On ``device``
    (default: CUDA) the wrappers launch ``csrc/event_conv.cu`` (batched,
    then once per slot) and :func:`event_conv_batched_ref` runs on the
    same card; on the CPU the wrappers run the plain version, batched and
    slot by slot.  Float weights, 80% open gates and clamped origins, the
    inputs drawn from ``numpy.random.default_rng(seed)`` on the CPU and
    moved.
    """
    import numpy as np

    from repro_torch.device import resolve_device
    from repro_torch.kernels.event_conv.ops import (event_conv,
                                                    event_conv_batched)

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    Hp, Wp = H + K - 1, W + K - 1
    v = rng.normal(size=(N, Hp, Wp, Co)).astype(np.float32)
    w = rng.normal(size=(K, K, Ci, Co)).astype(np.float32)
    xyc = np.stack([rng.integers(0, H, (N, E)), rng.integers(0, W, (N, E)),
                    rng.integers(0, Ci, (N, E))], -1).astype(np.int32)
    gate = (rng.random((N, E)) < 0.8).astype(np.float32)
    v, w, xyc, gate = (torch.from_numpy(a).to(dev) for a in (v, w, xyc, gate))
    batched = event_conv_batched(v, w, xyc, gate)
    plain = event_conv_batched_ref(v, w, xyc, gate)
    per_slot = torch.stack([event_conv(v[i], w, xyc[i], gate[i])
                            for i in range(N)])
    assert torch.equal(batched, plain), "batched kernel != plain version"
    assert torch.equal(batched, per_slot), \
        "batched kernel != the N = 1 face slot by slot"
