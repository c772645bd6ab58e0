"""Wrapper of the slot-batched event-conv scatter.

CPU tensors go to the plain PyTorch version (`ref.py`); CUDA tensors
launch the hand-written kernel ``csrc/event_conv.cu`` on the current
stream, or raise — there is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (LAUNCHES, check_batch, check_cuda,
                                         pairing, raise_on_error)
from repro_torch.kernels.event_conv.ref import event_conv_batched_ref

NAME = "event_conv_batched"
# a block keeps its slab slice, weights and event stage in shared memory
SMEM_BUDGET = 200 * 1024
MIN_THREADS = 64
ACC_BYTES = 4            # every pairing accumulates in f32 or int32
EVENT_STAGE_BYTES = 128 * 16   # kChunk events of (x, y, c, gate)


def conv_channel_block(Hp: int, Wp: int, Co: int, K: int, Ci: int) -> int:
    """Output channels per block: the smallest divisor of ``Co`` giving at
    least ``MIN_THREADS`` threads (one per patch offset), shrunk until the
    block's shared memory fits.  Raises if no block fits."""
    divisors = [b for b in range(1, Co + 1) if Co % b == 0]
    fits = [b for b in divisors if K * K * b <= 1024
            and ACC_BYTES * (Hp * Wp * b + K * K * Ci * b)
            + EVENT_STAGE_BYTES <= SMEM_BUDGET]
    if not fits:
        raise ValueError(f"{NAME}: a ({Hp}, {Wp}) slab with K={K} does not "
                         f"fit one block's shared memory")
    wide = [b for b in fits if K * K * b >= MIN_THREADS]
    return wide[0] if wide else fits[-1]


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
    if all(t.device.type == "cpu" for t in (v, weights, ev_xyc, ev_gate)):
        return event_conv_batched_ref(v, weights, ev_xyc, ev_gate, out_dtype)
    dev = check_cuda(NAME, v, weights, ev_xyc, ev_gate)
    N, Hp, Wp, Co = v.shape
    K, _, Ci, _ = weights.shape
    co_blk = conv_channel_block(Hp, Wp, Co, K, Ci)
    w_f = torch.flip(weights, (0, 1)).contiguous()
    out = torch.empty(v.shape, dtype=out_dtype, device=dev)
    fn = _build.library("event_conv").sne_event_conv_batched
    with torch.cuda.device(dev):
        err = fn(v.data_ptr(), w_f.data_ptr(), ev_xyc.data_ptr(),
                 ev_gate.data_ptr(), out.data_ptr(), N, Hp, Wp, Co, K, Ci,
                 ev_xyc.shape[1], co_blk, code,
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(NAME, err)
    LAUNCHES[NAME] += 1
    return out
