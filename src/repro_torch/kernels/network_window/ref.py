"""Plain PyTorch version of the fused-network window megakernel.

Counterpart of ``repro.kernels.network_window.ref.network_window_ref`` and
the twin of ``csrc/network_window.cu``: the whole layer chain over a whole
window, per timestep and per layer ``leak -> scatter -> clip -> fire ->
reset`` (then the int8 clamp on the native path and the ``alive``
freeze), with each layer's spike frame routed straight into the next
layer's event list.  The scatters are the port's slot-batched plain
scatters (already bitwise the per-step kernels), the boundary and routing
steps the `kernels.window_common` helpers, in the reference's order.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.event_conv.ref import event_conv_batched_ref
from repro_torch.kernels.event_fc.ref import event_fc_batched_ref
from repro_torch.kernels.event_pool.ref import event_pool_batched_ref
from repro_torch.kernels.network_window.spec import NetLayer
from repro_torch.kernels.window_common import (clip_fire_reset,
                                               cold_tile_decay,
                                               crop_interior, leak_boundary,
                                               route_frame, saturate_int8,
                                               tile_grid, tiles_to_sites,
                                               window_acc_dtype,
                                               write_cropped)


def _scatter(nl: NetLayer, w, acc, xyc, gate):
    """One layer's scatter of one timestep's events, all slots at once."""
    if nl.kind == "conv":
        return event_conv_batched_ref(acc, w, xyc, gate)
    if nl.kind == "pool":
        return event_pool_batched_ref(acc, w, xyc, gate, nl.stride)
    return event_fc_batched_ref(acc, w, xyc, gate, nl.in_shape)


def network_window_ref(states: Sequence[torch.Tensor],
                       weights: Sequence[torch.Tensor],
                       ev_xyc: torch.Tensor, ev_gate: torch.Tensor,
                       alive: torch.Tensor, *, layers: Tuple[NetLayer, ...],
                       native: bool = False,
                       tiles: Optional[Sequence[torch.Tensor]] = None):
    """Advance N slots through a whole window, all layers chained.

    Args:
      states:  per-layer membrane slabs, each (N, Hp, Wp, C), storage dtype.
      weights: per-layer weights (conv unflipped, pool per channel, fc
               matrix), shared by the slots.
      ev_xyc:  (N, T, E0, 3) int32 layer-0 schedule (a conv first layer
               takes halo coordinates).
      ev_gate: (N, T, E0) gates.
      alive:   (N, T) liveness: a frozen timestep holds every layer's
               state and emits no spikes.
      layers:  the per-layer plans (:class:`NetLayer`).
      native:  int8-native policy (int32 accumulator, int8 clamp).
      tiles:   optional per-layer (N, nTx_l, nTy_l) bitmaps: spikes of cold
               tiles are zeroed before routing, and cold interior sites
               end the window as the starting membrane settled by one
               :func:`window_common.cold_tile_decay`.  None runs dense.

    Returns ``(v_out tuple, s_last (N, T, Ho, Wo, C_last) accumulator
    dtype, counts (N, L) int32, drops (N, L) int32)``: ``counts`` are the
    events each layer consumed (layer 0's gates of frozen timesteps
    included), ``drops`` the routing overflow into each layer (column 0
    is 0; the collector counts input drops).
    """
    L = len(layers)
    N, T = ev_xyc.shape[:2]
    dev = ev_xyc.device
    acc_dts = [window_acc_dtype(v.dtype, native) for v in states]
    accs = [v.to(dt) for v, dt in zip(states, acc_dts)]
    interiors = [(v.shape[1] - 2 * nl.halo, v.shape[2] - 2 * nl.halo)
                 for nl, v in zip(layers, states)]
    cold = None
    if tiles is not None:
        cold = [(tiles_to_sites(tl.to(torch.float32), tile_grid(*shp), shp)
                 == 0)[..., None] for tl, shp in zip(tiles, interiors)]
    counts = torch.zeros((N, L), dtype=torch.int32, device=dev)
    drops = torch.zeros((N, L), dtype=torch.int32, device=dev)
    frames = []
    for t in range(T):
        a = (alive[:, t] > 0).reshape(N, 1, 1, 1)
        xyc = ev_xyc[:, t].contiguous()
        gate = ev_gate[:, t].to(acc_dts[0]).contiguous()
        counts[:, 0] += gate.to(torch.int32).sum(dim=1, dtype=torch.int32)
        for l, nl in enumerate(layers):
            h = nl.halo
            acc = write_cropped(accs[l], leak_boundary(
                crop_interior(accs[l], h), nl.lif), h)
            acc = _scatter(nl, weights[l], acc, xyc, gate)
            v_new, s = clip_fire_reset(crop_interior(acc, h), nl.lif)
            acc = write_cropped(acc, v_new, h)
            if native:
                acc = saturate_int8(acc)
            accs[l] = torch.where(a, acc, accs[l])
            s_t = torch.where(a, s, torch.zeros_like(s))
            if cold is not None:
                s_t = torch.where(cold[l], torch.zeros_like(s_t), s_t)
            if l == L - 1:
                frames.append(s_t)
                continue
            nxt = layers[l + 1]
            xyc, gate, n_drop = route_frame(s_t, nxt.cap)
            if nxt.kind == "conv":
                xyc = xyc + torch.tensor([nxt.padding, nxt.padding, 0],
                                         dtype=torch.int32, device=dev)
            counts[:, l + 1] += gate.to(torch.int32).sum(dim=1,
                                                         dtype=torch.int32)
            drops[:, l + 1] += n_drop
    outs = [acc.to(v.dtype) for acc, v in zip(accs, states)]
    if cold is not None:
        dt = (alive > 0).to(torch.int32).sum(dim=1).reshape(N, 1, 1, 1)
        for l, nl in enumerate(layers):
            h = nl.halo
            dec = cold_tile_decay(crop_interior(states[l], h).to(acc_dts[l]),
                                  nl.lif, dt).to(states[l].dtype)
            outs[l] = write_cropped(outs[l], torch.where(
                cold[l], dec, crop_interior(outs[l], h)), h)
    return tuple(outs), torch.stack(frames, dim=1), counts, drops
