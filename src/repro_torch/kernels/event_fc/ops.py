"""Wrappers of the event FC kernels: the slot-batched row-gather and the
fused window.

CPU tensors go to the plain PyTorch versions (`ref.py`); CUDA tensors
launch ``csrc/event_fc.cu`` and ``csrc/event_fc_window.cu`` on the
current stream, or raise.  Both kernels run the staged column walk of
``csrc/fc_walk.cuh`` on one block per (slot, column block), the column
blocks from :func:`fc_column_block`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (LAUNCHES, check_batch, check_cuda,
                                         lif_args, on_cpu, pairing,
                                         raise_on_error, window_pairing,
                                         window_schedule)
from repro_torch.kernels.event_fc.ref import (event_fc_batched_ref,
                                              event_fc_window_ref)

NAME = "event_fc_batched"
WINDOW_NAME = "event_fc_window"
# The column blocks of both kernels (csrc/fc_walk.cuh)
TARGET_BLOCKS = 132      # the H100's SMs: one block each
FC_THREADS = 256         # fc_walk.cuh kThreads: at most a column a thread
SEGMENT = 32             # columns of one 128-byte f32 row segment
PER_LANE = 4             # fc_walk.cuh kPerLane: events a lane filters
BUF_WORDS = 4096         # fc_walk.cuh kBufWords: words of one row buffer
# Shared memory of one block of either fc kernel, all of it static: the
# kept events of a stage (int2 each), the two row buffers and the warp
# partials (event_fc.cu, event_fc_window.cu)
FC_SMEM = 8 * PER_LANE * FC_THREADS + 4 * 2 * BUF_WORDS + 4 * 32


def fc_column_block(N: int, Dout: int) -> int:
    """Output columns per block of the fc kernels (per-step and window).

    Enough column blocks a slot that the ``N`` slots' blocks fill the
    card's :data:`TARGET_BLOCKS` SMs, each a whole number of
    :data:`SEGMENT`-column row segments (one coalesced read of a weight
    row), at most :data:`FC_THREADS` (each column has its own thread) and
    at most ``Dout``.  The last block of a slot takes what is left."""
    per_slot = max(1, TARGET_BLOCKS // max(N, 1))
    cols = -(-Dout // per_slot)
    cols = -(-cols // SEGMENT) * SEGMENT      # whole row segments
    return min(cols, FC_THREADS, Dout)


def event_fc_batched(v: torch.Tensor, w: torch.Tensor, ev_xyc: torch.Tensor,
                     ev_gate: torch.Tensor, in_shape: Tuple[int, int, int],
                     out_dtype=None) -> torch.Tensor:
    """Accumulate N slots' FC event batches into N output vectors.

    Args:
      v:        (N, 1, 1, Dout) membranes (f32, int8 or int32).
      w:        (Din, Dout) weights (f32, or int8 codes).
      ev_xyc:   (N, E, 3) int32 events in input coordinates.
      ev_gate:  (N, E) gates at the slab dtype.
      in_shape: (H, W, C) input geometry, ``H * W * C == Din``.
      out_dtype: accumulator dtype (default ``v.dtype``).

    Empty batches return the slab cast to the accumulator with no launch.
    """
    out_dtype = v.dtype if out_dtype is None else out_dtype
    check_batch(NAME, v, ev_xyc, ev_gate)
    H, Wi, Ci = in_shape
    if w.dim() != 2 or w.shape[0] != H * Wi * Ci or w.shape[1] != v.shape[-1] \
            or tuple(v.shape[1:3]) != (1, 1):
        raise ValueError(f"{NAME}: weights {tuple(w.shape)}, slab "
                         f"{tuple(v.shape)} and in_shape {in_shape} disagree")
    code = pairing(NAME, v, w, ev_gate, out_dtype)
    if v.shape[0] == 0 or ev_xyc.shape[1] == 0:
        return v.to(out_dtype, copy=True)
    if on_cpu(v, w, ev_xyc, ev_gate):
        return event_fc_batched_ref(v, w, ev_xyc, ev_gate, in_shape,
                                    out_dtype)
    dev = check_cuda(NAME, v, w, ev_xyc, ev_gate)
    N, Dout = v.shape[0], v.shape[-1]
    out = torch.empty(v.shape, dtype=out_dtype, device=dev)
    fn = _build.library("event_fc").sne_event_fc_batched
    with torch.cuda.device(dev):
        err = fn(v.data_ptr(), w.data_ptr(), ev_xyc.data_ptr(),
                 ev_gate.data_ptr(), out.data_ptr(), N, Wi, Ci, w.shape[0],
                 Dout, ev_xyc.shape[1], fc_column_block(N, Dout), code,
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(NAME, err)
    LAUNCHES[NAME] += 1
    return out


def event_fc(v: torch.Tensor, w: torch.Tensor, ev_xyc: torch.Tensor,
             ev_gate: torch.Tensor, in_shape: Tuple[int, int, int],
             out_dtype=None) -> torch.Tensor:
    """The single-stream face: one ``(1, 1, Dout)`` slab, ``(E, 3)`` events
    in input coordinates and ``(E,)`` gates.  Exactly
    :func:`event_fc_batched` at N = 1 (the reference's
    ``event_fc_pallas``): a CUDA slab launches ``csrc/event_fc.cu``,
    counted under :data:`NAME`."""
    return event_fc_batched(v[None], w, ev_xyc[None], ev_gate[None],
                            in_shape, out_dtype=out_dtype)[0]


def event_fc_window(v: torch.Tensor, w: torch.Tensor, ev_xyc: torch.Tensor,
                    ev_gate: torch.Tensor, alive: torch.Tensor, *, lif,
                    in_shape: Tuple[int, int, int], native: bool = False):
    """Advance N slots through a whole T-timestep fc window in one launch.

    Args:
      v:        (N, 1, 1, Dout) membranes, storage dtype (f32; int8 native).
      w:        (Din, Dout) weights (f32; int8 codes).
      ev_xyc:   (N, T, E, 3) int32 window schedule, input coordinates.
      ev_gate:  (N, T, E) gates (cast to the accumulator dtype).
      alive:    (N, T) liveness.
      lif, in_shape, native: LIF plan, (H, W, C) input geometry,
                int8-native policy.

    Returns ``(v_out, spikes (N, T, 1, 1, Dout))``, spikes in the
    accumulator dtype.  fc layers take no tile bitmap.
    """
    acc, ev_xyc, ev_gate, alive = window_schedule(WINDOW_NAME, v, ev_xyc,
                                                  ev_gate, alive, native)
    H, Wi, Ci = in_shape
    if w.dim() != 2 or w.shape[0] != H * Wi * Ci or w.shape[1] != v.shape[-1] \
            or tuple(v.shape[1:3]) != (1, 1):
        raise ValueError(f"{WINDOW_NAME}: weights {tuple(w.shape)}, slab "
                         f"{tuple(v.shape)} and in_shape {in_shape} disagree")
    code = window_pairing(WINDOW_NAME, v, w, ev_gate, acc)
    if on_cpu(v, w, ev_xyc, ev_gate, alive):
        return event_fc_window_ref(v, w, ev_xyc, ev_gate, alive, lif=lif,
                                   in_shape=in_shape, native=native)
    dev = check_cuda(WINDOW_NAME, v, w, ev_xyc, ev_gate, alive)
    N, Dout = v.shape[0], v.shape[-1]
    T, E = ev_xyc.shape[1], ev_xyc.shape[2]
    v_out = torch.empty_like(v)
    s_out = torch.empty((N, T, 1, 1, Dout), dtype=acc, device=dev)
    fn = _build.library("event_fc_window").sne_event_fc_window
    with torch.cuda.device(dev):
        err = fn(v.data_ptr(), w.data_ptr(), ev_xyc.data_ptr(),
                 ev_gate.data_ptr(), alive.data_ptr(), v_out.data_ptr(),
                 s_out.data_ptr(), N, T, E, Wi, Ci, w.shape[0], Dout,
                 fc_column_block(N, Dout), code,
                 *lif_args(lif), torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(WINDOW_NAME, err)
    LAUNCHES[WINDOW_NAME] += 1
    return v_out, s_out
