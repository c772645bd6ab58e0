"""Wrappers of the event sum-pool kernels: the slot-batched scatter and
the fused window.

CPU tensors go to the plain PyTorch versions (`ref.py`); CUDA tensors
launch ``csrc/event_pool.cu`` and ``csrc/event_pool_window.cu`` on the
current stream, or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (LAUNCHES, check_batch, check_cuda,
                                         check_tiles, lif_args, on_cpu,
                                         pairing, raise_on_error,
                                         window_pairing, window_schedule)
from repro_torch.kernels.event_pool.ref import (event_pool_batched_ref,
                                                event_pool_window_ref)
from repro_torch.kernels.window_common import tile_grid

NAME = "event_pool_batched"
WINDOW_NAME = "event_pool_window"
THREADS = 256            # the kernels' block size (pool_walk.cuh kThreads)
MAX_BLOCKS_PER_SLOT = 8
# sites a thread may own: its column of membranes in shared memory
MAX_OWNED_PER_THREAD = 64


# pool_walk.cuh: events a stage holds, and the per-warp partials
STAGE = 2048
WARPS = THREADS // 32
MAX_TILES = 16           # lif_common.cuh kMaxTiles: the window's hot bits


def pool_smem(n_sites: int, *, window: bool) -> int:
    """Shared memory of one block of the pool kernels (``window``: the
    window kernel's), static and dynamic: ``pool_walk.cuh``'s
    ``smem_bytes`` (two raw stages, the kept list, the warp partials and
    the block's owned membranes, at :func:`pool_blocks_per_slot` blocks a
    slot), plus the window kernel's static tile bits."""
    n_thr = pool_blocks_per_slot(n_sites) * THREADS
    owned = -(-n_sites // n_thr)
    smem = (2 * 4 * STAGE + 2 * STAGE + WARPS) * 4 + owned * THREADS * 4
    return smem + (4 * MAX_TILES if window else 0)


def pool_blocks_per_slot(n_sites: int) -> int:
    """Blocks sharing one slot's sites: a power of two, about one site per
    thread, at most ``MAX_BLOCKS_PER_SLOT`` unless the owned membranes
    would pass ``MAX_OWNED_PER_THREAD`` sites a thread."""
    p = 1
    while p < MAX_BLOCKS_PER_SLOT and p * THREADS < n_sites:
        p *= 2
    while p * THREADS * MAX_OWNED_PER_THREAD < n_sites:
        p *= 2
    return p


def event_pool_batched(v: torch.Tensor, w: torch.Tensor,
                       ev_xyc: torch.Tensor, ev_gate: torch.Tensor,
                       stride: int, out_dtype=None) -> torch.Tensor:
    """Accumulate N slots' pooled event batches into N slabs.

    Args:
      v:        (N, Ho, Wo, C) membrane slabs (f32, int8 or int32).
      w:        (C,) per-channel weights (f32, or int8 codes).
      ev_xyc:   (N, E, 3) int32 events in input coordinates.
      ev_gate:  (N, E) gates at the slab dtype.
      stride:   pooling stride.
      out_dtype: accumulator dtype (default ``v.dtype``).

    Empty batches return the slab cast to the accumulator with no launch.
    """
    out_dtype = v.dtype if out_dtype is None else out_dtype
    check_batch(NAME, v, ev_xyc, ev_gate)
    if w.dim() != 1 or w.shape[0] != v.shape[3]:
        raise ValueError(f"{NAME}: weights {tuple(w.shape)} do not match "
                         f"slab {tuple(v.shape)}")
    if stride < 1:
        raise ValueError(f"{NAME}: stride {stride} < 1")
    code = pairing(NAME, v, w, ev_gate, out_dtype)
    if v.shape[0] == 0 or ev_xyc.shape[1] == 0:
        return v.to(out_dtype, copy=True)
    if on_cpu(v, w, ev_xyc, ev_gate):
        return event_pool_batched_ref(v, w, ev_xyc, ev_gate, stride,
                                      out_dtype)
    dev = check_cuda(NAME, v, w, ev_xyc, ev_gate)
    N, Ho, Wo, C = v.shape
    out = torch.empty(v.shape, dtype=out_dtype, device=dev)
    fn = _build.library("event_pool").sne_event_pool_batched
    with torch.cuda.device(dev):
        err = fn(v.data_ptr(), w.data_ptr(), ev_xyc.data_ptr(),
                 ev_gate.data_ptr(), out.data_ptr(), N, Ho, Wo, C, stride,
                 ev_xyc.shape[1], pool_blocks_per_slot(Ho * Wo * C), code,
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(NAME, err)
    LAUNCHES[NAME] += 1
    return out


def event_pool(v: torch.Tensor, w: torch.Tensor, ev_xyc: torch.Tensor,
               ev_gate: torch.Tensor, stride: int,
               out_dtype=None) -> torch.Tensor:
    """The single-stream face: one ``(Ho, Wo, C)`` slab, ``(E, 3)`` events
    in input coordinates and ``(E,)`` gates.  Exactly
    :func:`event_pool_batched` at N = 1 (the reference's
    ``event_pool_pallas``): a CUDA slab launches ``csrc/event_pool.cu``,
    counted under :data:`NAME`."""
    return event_pool_batched(v[None], w, ev_xyc[None], ev_gate[None],
                              stride, out_dtype=out_dtype)[0]


def event_pool_window(v: torch.Tensor, w: torch.Tensor, ev_xyc: torch.Tensor,
                      ev_gate: torch.Tensor, alive: torch.Tensor, *, lif,
                      stride: int, native: bool = False, tiles=None):
    """Advance N slots through a whole T-timestep pool window in one launch.

    Args:
      v:       (N, Ho, Wo, C) membranes, storage dtype (f32; int8 native).
      w:       (C,) per-channel weights (f32; int8 codes).
      ev_xyc:  (N, T, E, 3) int32 window schedule, input coordinates.
      ev_gate: (N, T, E) gates (cast to the accumulator dtype).
      alive:   (N, T) liveness.
      lif, stride, native: LIF plan, pooling stride, int8-native policy.
      tiles:   optional (N, nTx, nTy) tile bitmap over (Ho, Wo);
               hard-reset layers only.  None runs every tile.

    Returns ``(v_out, spikes (N, T, Ho, Wo, C))``, spikes in the
    accumulator dtype.
    """
    acc, ev_xyc, ev_gate, alive = window_schedule(WINDOW_NAME, v, ev_xyc,
                                                  ev_gate, alive, native)
    if w.dim() != 1 or w.shape[0] != v.shape[3]:
        raise ValueError(f"{WINDOW_NAME}: weights {tuple(w.shape)} do not "
                         f"match slab {tuple(v.shape)}")
    if stride < 1:
        raise ValueError(f"{WINDOW_NAME}: stride {stride} < 1")
    N, Ho, Wo, C = v.shape
    nTx, nTy, th, tw = tile_grid(Ho, Wo)
    check_tiles(WINDOW_NAME, tiles, lif, N, (nTx, nTy))
    code = window_pairing(WINDOW_NAME, v, w, ev_gate, acc)
    if on_cpu(v, w, ev_xyc, ev_gate, alive, tiles):
        return event_pool_window_ref(v, w, ev_xyc, ev_gate, alive, lif=lif,
                                     stride=stride, native=native,
                                     tiles=tiles)
    if tiles is not None:
        tiles = tiles.to(torch.int32)
    dev = check_cuda(WINDOW_NAME, v, w, ev_xyc, ev_gate, alive,
                     *(() if tiles is None else (tiles,)))
    T, E = ev_xyc.shape[1], ev_xyc.shape[2]
    v_out = torch.empty_like(v)
    s_out = torch.empty((N, T, Ho, Wo, C), dtype=acc, device=dev)
    fn = _build.library("event_pool_window").sne_event_pool_window
    with torch.cuda.device(dev):
        err = fn(v.data_ptr(), w.data_ptr(), ev_xyc.data_ptr(),
                 ev_gate.data_ptr(), alive.data_ptr(),
                 None if tiles is None else tiles.data_ptr(),
                 v_out.data_ptr(), s_out.data_ptr(), N,
                 Ho, Wo, C, stride, T, E, nTx, nTy, th, tw,
                 pool_blocks_per_slot(Ho * Wo * C), code, *lif_args(lif),
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(WINDOW_NAME, err)
    LAUNCHES[WINDOW_NAME] += 1
    return v_out, s_out
