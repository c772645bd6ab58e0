"""Wrapper of the fused LIF kernel.

CPU tensors go to the plain PyTorch version (`ref.py`); CUDA tensors
launch ``csrc/lif_fused.cu`` on the current stream, or raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (LAUNCHES, check_cuda, on_cpu,
                                         raise_on_error)
from repro_torch.kernels.lif.ref import lif_fused_ref

NAME = "lif_fused"


def lif_fused(v: torch.Tensor, syn: torch.Tensor, dt, leak: float,
              threshold: float, state_clip: Optional[float] = None):
    """Fused lazy leak, integrate, saturate, fire and reset.

    Args:
      v:          float32 membranes, any shape.
      syn:        float32 synaptic input of ``v``'s shape.
      dt:         the leak steps to apply at once (a number or a one-element
                  tensor; on the card a tensor is read there, with no host
                  synchronisation).
      leak, threshold, state_clip: the LIF plan (no clip when None).

    Returns ``(v_next, spikes)`` of ``v``'s shape, float32.
    """
    if v.dtype != torch.float32 or syn.dtype != torch.float32:
        raise TypeError(f"{NAME}: float32 operands only, got {v.dtype} and "
                        f"{syn.dtype}")
    if v.shape != syn.shape:
        raise ValueError(f"{NAME}: v {tuple(v.shape)} and syn "
                         f"{tuple(syn.shape)} differ")
    if isinstance(dt, torch.Tensor) and dt.numel() != 1:
        raise ValueError(f"{NAME}: dt must be one value, got shape "
                         f"{tuple(dt.shape)}")
    dt_t = dt if isinstance(dt, torch.Tensor) else None
    if on_cpu(v, syn, dt_t):
        return lif_fused_ref(v, syn, dt, leak, threshold, state_clip)
    dev = check_cuda(NAME, v, syn)
    dt_t = torch.as_tensor(dt, dtype=torch.float32, device=dev).reshape(())
    check_cuda(NAME, dt_t)
    v_out = torch.empty_like(v)
    s_out = torch.empty_like(v)
    if v.numel() == 0:
        return v_out, s_out
    fn = _build.library(NAME).sne_lif_fused
    with torch.cuda.device(dev):
        err = fn(v.data_ptr(), syn.data_ptr(), dt_t.data_ptr(),
                 v_out.data_ptr(), s_out.data_ptr(), v.numel(), float(leak),
                 float(threshold),
                 0.0 if state_clip is None else float(state_clip),
                 int(state_clip is not None),
                 torch.cuda.current_stream(dev).cuda_stream)
    raise_on_error(NAME, err)
    LAUNCHES[NAME] += 1
    return v_out, s_out
