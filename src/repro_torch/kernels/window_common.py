"""What the fused window kernels share: the LIF boundary sequence, the
halo crop, the routing of a spike frame into an event list, the tile
activity bitmaps and the plain window sequence.

Counterpart of ``repro.kernels.window_common``.  A fused window runs the whole
``leak -> scatter -> clip -> fire -> reset`` chain for every timestep of a
serving window in ONE launch per layer; its boundary arithmetic must stay
bitwise the per-step executor's, so :func:`leak_boundary` and
:func:`clip_fire_reset` call straight into `core.lif`, the one source both
executors share.

This module sits on the kernel side of the layering: it imports `core.lif`
and `core.quant` (which import no kernels), and the kernel packages import
it; `core.layer_program` imports it too (the halo crop lives here), so it
must never import the executor.

**Tile activity bitmaps.**  One ``(N, nTx, nTy)`` int32 bitmap per layer
marks which tiles of each slot's membrane *interior* can be touched this
window: seeded from the collector's events (:func:`seed_site_map`),
propagated through each layer's receptive field (:func:`dilate_conv`,
:func:`dilate_pool`; fc layers are always hot) and coarsened to the tile
grid (:func:`sites_to_tiles`).  The bitmap is a superset of the interior
sites a window's scatters write; since hard-reset membranes sit below
threshold at every boundary, a cold tile neither receives input nor fires,
and its whole window collapses to one :func:`cold_tile_decay`.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.lif import (LifParams, apply_leak, fire_and_reset,
                                  idle_decay)
from repro_torch.core.quant import INT8_MAX, INT8_MIN

# Tiles per spatial axis of one membrane interior (at most): the
# reference's launch geometry, kept so the bitmaps agree tile for tile.
TILE_GRID_MAX = 4


def pad_empty_schedule(ev_xyc: torch.Tensor, ev_gate: torch.Tensor):
    """Pad a zero-length event axis to one gated-off event.

    A fused window still runs its leak/fire boundaries with no events, so
    an ``(N, T, 0, 3)`` schedule becomes one padding event per timestep
    with gate 0 (coordinates 0).
    """
    if ev_xyc.shape[2] == 0:
        ev_xyc = F.pad(ev_xyc, (0, 0, 0, 1))
        ev_gate = F.pad(ev_gate, (0, 1))
    return ev_xyc, ev_gate


def window_acc_dtype(storage_dtype: torch.dtype, native: bool) -> torch.dtype:
    """Accumulator dtype of a fused window: int32 on the native path (the
    int8 slab widened for the whole window), else the storage dtype."""
    return torch.int32 if native else storage_dtype


def leak_boundary(v: torch.Tensor, lif: LifParams) -> torch.Tensor:
    """One timestep boundary's leak (``dt == 1``), `core.lif.apply_leak`."""
    return apply_leak(v, lif.leak, 1, lif.leak_mode)


def clip_fire_reset(v: torch.Tensor, lif: LifParams):
    """Clip to ±``state_clip`` (if any), threshold, emit, reset.

    Returns ``(v_next, spikes)`` in ``v.dtype``.
    """
    if lif.state_clip is not None:
        c = torch.as_tensor(lif.state_clip, dtype=v.dtype, device=v.device)
        v = torch.clamp(v, -c, c)
    return fire_and_reset(v, lif)


def saturate_int8(v: torch.Tensor) -> torch.Tensor:
    """int8 storage saturation expressed in the accumulator dtype (the
    per-step executor's whole-slab downcast, round trip included)."""
    return torch.clamp(v, INT8_MIN, INT8_MAX)


def route_frame(s: torch.Tensor, cap: int):
    """Dense spike frames -> padded event lists (the routing between two
    layers).

    ``s`` is ``(..., H, W, C)``: one frame, or a batch of them along the
    leading axes.  Each frame keeps its first ``cap' = min(cap, H*W*C)``
    nonzero sites in row-major ``(x, y, c)`` order; padding gets gate 0
    and the coordinates of the last site; the overflow past ``cap'`` is
    counted.  Bitwise the reference's ``route_frame`` (one frame) and
    ``frame_to_events`` (a batch).

    Returns ``(xyc (..., cap', 3) int32, gate (..., cap') in s.dtype,
    n_drop (...) int32)``.
    """
    H, W, C = s.shape[-3:]
    S = H * W * C
    cap = min(cap, S)
    nz = s.reshape(*s.shape[:-3], S) != 0
    idx = torch.arange(S, device=s.device, dtype=torch.int64)
    key = torch.where(nz, idx, torch.full_like(idx, S))
    order = torch.topk(key, cap, dim=-1, largest=False, sorted=True).values
    gate = (order < S).to(s.dtype)
    order = torch.clamp(order, max=S - 1)
    xyc = torch.stack([order // (W * C), (order // C) % W, order % C],
                      dim=-1).to(torch.int32)
    n = nz.sum(dim=-1, dtype=torch.int32)
    n_drop = torch.clamp(n - cap, min=0)
    return xyc, gate, n_drop


def crop_interior(vp: torch.Tensor, h: int) -> torch.Tensor:
    """Crop the halo off ``(..., Hp, Wp, C)`` (a view)."""
    if h == 0:
        return vp
    return vp[..., h:vp.shape[-3] - h, h:vp.shape[-2] - h, :]


def write_cropped(vp: torch.Tensor, x: torch.Tensor, h: int) -> torch.Tensor:
    """A new buffer: ``vp`` with its interior replaced by ``x``."""
    if h == 0:
        return x
    out = vp.clone()
    out[..., h:vp.shape[-3] - h, h:vp.shape[-2] - h, :] = x
    return out


# ---------------------------------------------------------------------------
# Tile activity bitmaps.
# ---------------------------------------------------------------------------

def tile_grid(H: int, W: int):
    """Tile grid of an (H, W) interior: ``(nTx, nTy, th, tw)``.

    At most :data:`TILE_GRID_MAX` tiles per axis; edge tiles may be
    smaller, none is empty.  An empty interior has no grid: the reference
    divides by zero there, the port raises ``ValueError``.
    """
    if H < 1 or W < 1:
        raise ValueError(f"tile_grid: an interior of {H} x {W} sites has no "
                         f"tiles (the layer's output is empty)")
    th = -(-H // min(H, TILE_GRID_MAX))
    tw = -(-W // min(W, TILE_GRID_MAX))
    return (-(-H // th), -(-W // tw), th, tw)


def seed_site_map(ev_xyc: torch.Tensor, ev_gate: torch.Tensor,
                  shape) -> torch.Tensor:
    """Collector events -> (N, H, W) float32 site-activity map.

    Marks every site a gated event names, any channel; out-of-range
    coordinates are ignored.  Coordinates repeat, so the scatter takes the
    max (never a plain indexed write, which keeps an arbitrary writer).

    Args:
      ev_xyc:  (T, N, E, 3) int32 events in layer coordinates.
      ev_gate: (T, N, E) validity gates.
      shape:   the layer's (H, W) input geometry.
    """
    H, W = shape
    T, N, E = ev_gate.shape
    x, y = ev_xyc[..., 0].long(), ev_xyc[..., 1].long()
    ok = (ev_gate > 0) & (x >= 0) & (x < H) & (y >= 0) & (y < W)
    flat = x.clamp(0, H - 1) * W + y.clamp(0, W - 1)
    slot = torch.arange(N, device=ev_xyc.device).reshape(1, N, 1)
    idx = (slot * (H * W) + flat).reshape(-1)
    m = torch.zeros((N * H * W,), dtype=torch.float32, device=ev_xyc.device)
    m.scatter_reduce_(0, idx, ok.reshape(-1).to(torch.float32),
                      reduce="amax")
    return m.reshape(N, H, W)


def dilate_conv(site_map: torch.Tensor, kernel: int,
                padding: int) -> torch.Tensor:
    """Propagate an input site map through a conv's scatter footprint.

    Output site ``r`` can be touched iff an active input lies in
    ``[r - P, r - P + K - 1]``: a max over a K-window, stride 1, with P
    sites of zero padding on both sides (the reference's ``reduce_window``
    pads with its init 0.0; ``max_pool2d`` would pad with −inf and caps the
    padding at K/2, so the zeros are padded first).
    (N, H, W) -> (N, H + 2P - K + 1, W + 2P - K + 1).
    """
    m = F.pad(site_map, (padding, padding, padding, padding))
    return F.max_pool2d(m[:, None], kernel, stride=1)[:, 0]


def dilate_pool(site_map: torch.Tensor, stride: int,
                out_shape) -> torch.Tensor:
    """Propagate an input site map through a pool's footprint: input
    ``(x, y)`` lands on ``(x // s, y // s)``; sites past the output grid
    are dropped first (the VALID rule).  (N, H, W) -> (N, Ho, Wo)."""
    Ho, Wo = out_shape
    m = site_map[:, :Ho * stride, :Wo * stride]
    return F.max_pool2d(m[:, None], stride, stride=stride)[:, 0]


def sites_to_tiles(site_map: torch.Tensor, grid) -> torch.Tensor:
    """Reduce an (N, H, W) site map to its (N, nTx, nTy) int32 bitmap."""
    nTx, nTy, th, tw = grid
    _, H, W = site_map.shape
    m = F.pad(site_map, (0, nTy * tw - W, 0, nTx * th - H))
    t = F.max_pool2d(m[:, None], (th, tw), stride=(th, tw))[:, 0]
    return (t > 0).to(torch.int32)


def tiles_to_sites(tiles: torch.Tensor, grid, shape) -> torch.Tensor:
    """Upsample a tile bitmap back to site granularity, cropped to
    ``shape``."""
    _, _, th, tw = grid
    H, W = shape
    m = tiles.repeat_interleave(th, dim=-2).repeat_interleave(tw, dim=-1)
    return m[..., :H, :W]


def cold_tile_decay(v: torch.Tensor, lif: LifParams, dt) -> torch.Tensor:
    """A cold tile's whole window as one analytic decay over its ``dt``
    alive timesteps (`core.lif.idle_decay`; ``dt == 0`` is a no-op)."""
    return idle_decay(v, lif, dt)


def fused_window_ref(v: torch.Tensor, ev_xyc: torch.Tensor,
                     ev_gate: torch.Tensor, alive: torch.Tensor,
                     scatter: Callable, *, lif: LifParams, halo: int,
                     native: bool, tiles: Optional[torch.Tensor] = None):
    """The plain window sequence shared by every ``*_window_ref``.

    Per timestep, for all slots at once: ``leak -> scatter -> clip ->
    fire -> reset``, then (native) int8 saturation of the whole slab, then
    the ``alive`` freeze, in the order the kernels run it.
    ``scatter(acc, xyc_t, gate_t)`` is the kind's slot-batched plain
    scatter, already the per-step kernel's arithmetic.

    With ``tiles``, cold interior sites are patched to the tile-sparse
    kernels' result: the starting membrane settled with one
    :func:`cold_tile_decay`, and spike frames zero there.  Halo cells
    belong to no tile and keep the dense result.

    Args:
      v:       (N, Hp, Wp, C) membranes in storage dtype.
      ev_xyc:  (N, T, E, 3) int32 window schedule (slot-major).
      ev_gate: (N, T, E) validity gates.
      alive:   (N, T) per-timestep liveness.
      scatter: the kind's slot-batched plain scatter.
      lif, halo, native: the layer's LIF plan, halo width and policy.
      tiles:   optional (N, nTx, nTy) interior tile bitmap.

    Returns ``(v_out storage dtype, spikes (N, T, Ho, Wo, C) accumulator
    dtype)``.
    """
    acc_dt = window_acc_dtype(v.dtype, native)
    T = ev_xyc.shape[1]
    acc = v.to(acc_dt)
    frames = []
    for t in range(T):
        prev = acc
        acc = write_cropped(acc, leak_boundary(crop_interior(acc, halo), lif),
                            halo)
        acc = scatter(acc, ev_xyc[:, t].contiguous(),
                      ev_gate[:, t].to(acc_dt).contiguous())
        v_new, s = clip_fire_reset(crop_interior(acc, halo), lif)
        acc = write_cropped(acc, v_new, halo)
        if native:
            acc = saturate_int8(acc)
        a = (alive[:, t] > 0).reshape(-1, 1, 1, 1)
        acc = torch.where(a, acc, prev)
        frames.append(torch.where(a, s, torch.zeros_like(s)))
    v_out = acc.to(v.dtype)
    frames = torch.stack(frames, dim=1)
    if tiles is None:
        return v_out, frames
    H = v.shape[1] - 2 * halo
    W = v.shape[2] - 2 * halo
    grid = tile_grid(H, W)
    mask = tiles_to_sites(tiles.to(torch.float32), grid, (H, W))
    cold = (mask == 0)[:, :, :, None]                        # (N, H, W, 1)
    dt = (alive > 0).to(torch.int32).sum(dim=1).reshape(-1, 1, 1, 1)
    dec = cold_tile_decay(crop_interior(v, halo).to(acc_dt), lif, dt)
    v_out = write_cropped(v_out, torch.where(cold, dec.to(v.dtype),
                                             crop_interior(v_out, halo)),
                          halo)
    frames = torch.where(cold[:, None], torch.zeros((), dtype=frames.dtype,
                                                    device=frames.device),
                         frames)
    return v_out, frames
