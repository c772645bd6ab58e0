"""Wrapper of the slot-batched event sum-pool scatter.

CPU tensors go to the plain PyTorch version (`ref.py`); CUDA tensors
launch ``csrc/event_pool.cu`` on the current stream, or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (LAUNCHES, check_batch, check_cuda,
                                         pairing, raise_on_error)
from repro_torch.kernels.event_pool.ref import event_pool_batched_ref

NAME = "event_pool_batched"
THREADS = 256            # the kernel's block size (kThreads)
MAX_BLOCKS_PER_SLOT = 8


def pool_blocks_per_slot(n_sites: int) -> int:
    """Blocks sharing one slot's sites: a power of two, about one site per
    thread, at most ``MAX_BLOCKS_PER_SLOT``."""
    p = 1
    while p < MAX_BLOCKS_PER_SLOT and p * THREADS < n_sites:
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
    if all(t.device.type == "cpu" for t in (v, w, ev_xyc, ev_gate)):
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
