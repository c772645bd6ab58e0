"""Wrappers of the event-conv kernels: the slot-batched scatter and the
fused window.

CPU tensors go to the plain PyTorch versions (`ref.py`); CUDA tensors
launch the hand-written kernels ``csrc/event_conv.cu`` and
``csrc/event_conv_window.cu`` on the current stream, or raise — there is
no fallback from one to the other.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (LAUNCHES, check_batch, check_cuda,
                                         check_tiles, lif_args, on_cpu,
                                         pairing, raise_on_error,
                                         window_pairing, window_schedule)
from repro_torch.kernels.event_conv.ref import (event_conv_batched_ref,
                                                event_conv_window_ref)
from repro_torch.kernels.window_common import tile_grid

NAME = "event_conv_batched"
WINDOW_NAME = "event_conv_window"
# The blocks of both conv kernels (csrc/event_conv.cu and
# csrc/event_conv_window.cu on csrc/conv_walk.cuh)
TARGET_BLOCKS = 132            # the H100's SMs: one block each
BLOCK_SMEM = 232_448           # the H100's opt-in shared memory per block
BLOCK_THREADS = (256, 512)     # conv_walk.cuh kMinThreads, kMaxThreads
PER_LANE = 4                   # events a thread filters per stage (kPerLane)
SEG = 8                        # sites of one lane a run holds (kSeg)
ACC_BYTES = 4                  # every pairing accumulates in f32 or int32


def conv_smem(band_rows: int, Wp: int, co_blk: int, K: int, Ci: int, *,
              window: bool) -> int:
    """Shared memory of one block (``smem_bytes`` of ``event_conv.cu`` and
    ``event_conv_window.cu``): the kept events of a stage, the band's
    sites, the weights and the warp partials; the window kernel adds one
    hot bit per site and the tile bitmap."""
    lanes = band_rows * co_blk
    runs = lanes * -(-Wp // SEG)
    lo, hi = BLOCK_THREADS
    threads = min(hi, max(lo, -(-runs // 32) * 32))
    smem = (16 * PER_LANE * threads
            + ACC_BYTES * (Wp * lanes + K * K * Ci * co_blk) + 4 * 32)
    if window:
        smem += 4 * band_rows * -(-Wp // 32) + 4 * 16
    return smem


def conv_plan(N: int, Hp: int, Wp: int, Co: int, K: int, Ci: int, *,
              window: bool) -> Tuple[int, int]:
    """``(band_rows, co_blk)`` of a conv kernel's blocks (``window``: the
    window kernel's, else the per-step scatter's).

    A block owns a band of at most ``band_rows`` slab rows (a slot's rows
    dealt to its ``ceil(Hp / band_rows)`` bands in turn) at ``co_blk``
    output channels: all ``Co`` unless shared memory forces a channel
    block.  There are enough bands that the ``N`` slots fill the card's
    :data:`TARGET_BLOCKS` SMs (at 8 slots: 16 bands a slot), made thicker
    only while shared memory allows.  One row at one channel holds a slab
    row of any width the card serves; raises if not even that fits (the
    weights of one channel past :data:`BLOCK_SMEM`)."""
    name = WINDOW_NAME if window else NAME
    for co_blk in sorted((b for b in range(1, Co + 1) if Co % b == 0),
                         reverse=True):
        blocks = N * (Co // co_blk)
        bands = max(1, min(Hp, TARGET_BLOCKS // blocks))
        rows = -(-Hp // bands)

        def smem(r):
            return conv_smem(r, Wp, co_blk, K, Ci, window=window)
        while rows > 1 and smem(rows) > BLOCK_SMEM:
            rows -= 1
        if smem(rows) <= BLOCK_SMEM:
            return rows, co_blk
    raise ValueError(f"{name}: a ({Hp}, {Wp}) slab with K={K}, Ci={Ci} "
                     f"does not fit one block's shared memory")


def event_conv_batched(v: torch.Tensor, weights: torch.Tensor,
                       ev_xyc: torch.Tensor, ev_gate: torch.Tensor,
                       out_dtype=None) -> torch.Tensor:
    """Accumulate N slots' event batches into N halo-padded slabs.

    Args:
      v:        (N, Hp, Wp, Co) membrane slabs (f32, int8 or int32).
      weights:  (K, K, Ci, Co) conv weights, unflipped (f32 or int8 codes).
      ev_xyc:   (N, E, 3) int32 events in halo coordinates.
      ev_gate:  (N, E) gates at the slab dtype.
      out_dtype: accumulator dtype (default ``v.dtype``; int32 on the
               native path).

    Empty batches (``N == 0`` or ``E == 0``) return the slab cast to the
    accumulator with no launch.
    """
    out_dtype = v.dtype if out_dtype is None else out_dtype
    check_batch(NAME, v, ev_xyc, ev_gate)
    if weights.dim() != 4 or weights.shape[0] != weights.shape[1] \
            or weights.shape[3] != v.shape[3]:
        raise ValueError(f"{NAME}: weights {tuple(weights.shape)} do not "
                         f"match slab {tuple(v.shape)}")
    code = pairing(NAME, v, weights, ev_gate, out_dtype)
    if v.shape[0] == 0 or ev_xyc.shape[1] == 0:
        return v.to(out_dtype, copy=True)
    if on_cpu(v, weights, ev_xyc, ev_gate):
        return event_conv_batched_ref(v, weights, ev_xyc, ev_gate, out_dtype)
    dev = check_cuda(NAME, v, weights, ev_xyc, ev_gate)
    N, Hp, Wp, Co = v.shape
    K, _, Ci, _ = weights.shape
    band_rows, co_blk = conv_plan(N, Hp, Wp, Co, K, Ci, window=False)
    out = torch.empty(v.shape, dtype=out_dtype, device=dev)
    fn = _build.library("event_conv").sne_event_conv_batched
    with torch.cuda.device(dev):
        err = fn(v.data_ptr(), weights.data_ptr(), ev_xyc.data_ptr(),
                 ev_gate.data_ptr(), out.data_ptr(), N, Hp, Wp, Co, K, Ci,
                 ev_xyc.shape[1], co_blk, band_rows, code,
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(NAME, err)
    LAUNCHES[NAME] += 1
    return out


def event_conv(v: torch.Tensor, weights: torch.Tensor, ev_xyc: torch.Tensor,
               ev_gate: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """The single-stream face: one ``(Hp, Wp, Co)`` halo-padded slab,
    ``(E, 3)`` events in halo coordinates and ``(E,)`` gates.  Exactly
    :func:`event_conv_batched` at N = 1 (the reference's
    ``event_conv_pallas``): a CUDA slab launches ``csrc/event_conv.cu``,
    counted under :data:`NAME`."""
    return event_conv_batched(v[None], weights, ev_xyc[None], ev_gate[None],
                              out_dtype=out_dtype)[0]


def event_conv_window(v: torch.Tensor, weights: torch.Tensor,
                      ev_xyc: torch.Tensor, ev_gate: torch.Tensor,
                      alive: torch.Tensor, *, lif, halo: int,
                      native: bool = False, tiles=None):
    """Advance N slots through a whole T-timestep conv window in one launch.

    Args:
      v:       (N, Hp, Wp, Co) halo-padded membranes, storage dtype (f32;
               int8 on the native path).
      weights: (K, K, Ci, Co) conv weights, unflipped (f32; int8 codes).
      ev_xyc:  (N, T, E, 3) int32 window schedule in halo coordinates.
      ev_gate: (N, T, E) gates (cast to the accumulator dtype).
      alive:   (N, T) liveness; a frozen timestep holds state, emits 0.
      lif:     the layer's `LifParams`; halo: its halo width.
      native:  int8-native policy (int32 accumulator, int8 clamp).
      tiles:   optional (N, nTx, nTy) interior tile bitmap
               (`window_common.tile_grid`); hard-reset layers only.
               None runs every tile.

    A zero-length event axis still runs the window (leak and fire must
    advance).  Returns ``(v_out, spikes (N, T, Ho, Wo, Co))``, spikes in
    the accumulator dtype.
    """
    acc, ev_xyc, ev_gate, alive = window_schedule(WINDOW_NAME, v, ev_xyc,
                                                  ev_gate, alive, native)
    if weights.dim() != 4 or weights.shape[0] != weights.shape[1] \
            or weights.shape[3] != v.shape[3]:
        raise ValueError(f"{WINDOW_NAME}: weights {tuple(weights.shape)} do "
                         f"not match slab {tuple(v.shape)}")
    N, Hp, Wp, Co = v.shape
    nTx, nTy, th, tw = tile_grid(Hp - 2 * halo, Wp - 2 * halo)
    check_tiles(WINDOW_NAME, tiles, lif, N, (nTx, nTy))
    code = window_pairing(WINDOW_NAME, v, weights, ev_gate, acc)
    if on_cpu(v, weights, ev_xyc, ev_gate, alive, tiles):
        return event_conv_window_ref(v, weights, ev_xyc, ev_gate, alive,
                                     lif=lif, halo=halo, native=native,
                                     tiles=tiles)
    if tiles is not None:
        tiles = tiles.to(torch.int32)
    dev = check_cuda(WINDOW_NAME, v, weights, ev_xyc, ev_gate, alive,
                     *(() if tiles is None else (tiles,)))
    K, _, Ci, _ = weights.shape
    T, E = ev_xyc.shape[1], ev_xyc.shape[2]
    band_rows, co_blk = conv_plan(N, Hp, Wp, Co, K, Ci, window=True)
    v_out = torch.empty_like(v)
    s_out = torch.empty((N, T, Hp - 2 * halo, Wp - 2 * halo, Co),
                        dtype=acc, device=dev)
    fn = _build.library("event_conv_window").sne_event_conv_window
    with torch.cuda.device(dev):
        err = fn(v.data_ptr(), weights.data_ptr(), ev_xyc.data_ptr(),
                 ev_gate.data_ptr(), alive.data_ptr(),
                 None if tiles is None else tiles.data_ptr(),
                 v_out.data_ptr(), s_out.data_ptr(), N, Hp, Wp, Co, K, Ci,
                 halo, T, E, co_blk, band_rows, nTx, nTy, th, tw, code,
                 *lif_args(lif),
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(WINDOW_NAME, err)
    LAUNCHES[WINDOW_NAME] += 1
    return v_out, s_out
