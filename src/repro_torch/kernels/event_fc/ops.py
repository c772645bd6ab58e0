"""Wrapper of the slot-batched event FC row-gather.

CPU tensors go to the plain PyTorch version (`ref.py`); CUDA tensors
launch ``csrc/event_fc.cu`` on the current stream, or raise.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (LAUNCHES, check_batch, check_cuda,
                                         pairing, raise_on_error)
from repro_torch.kernels.event_fc.ref import event_fc_batched_ref

NAME = "event_fc_batched"


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
    if all(t.device.type == "cpu" for t in (v, w, ev_xyc, ev_gate)):
        return event_fc_batched_ref(v, w, ev_xyc, ev_gate, in_shape,
                                    out_dtype)
    dev = check_cuda(NAME, v, w, ev_xyc, ev_gate)
    N, Dout = v.shape[0], v.shape[-1]
    out = torch.empty(v.shape, dtype=out_dtype, device=dev)
    fn = _build.library("event_fc").sne_event_fc_batched
    with torch.cuda.device(dev):
        err = fn(v.data_ptr(), w.data_ptr(), ev_xyc.data_ptr(),
                 ev_gate.data_ptr(), out.data_ptr(), N, Wi, Ci, w.shape[0],
                 Dout, ev_xyc.shape[1], code,
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(NAME, err)
    LAUNCHES[NAME] += 1
    return out
