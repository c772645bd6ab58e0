"""What the three scatter wrappers share: launch counts, the dtype
pairings the kernels take, and the checks made before a launch."""
from __future__ import annotations

from typing import Dict, Optional

import torch

# one count per CUDA kernel; a wrapper adds one where it launches its
# kernel and nowhere else (the plain path and empty batches add nothing)
LAUNCHES: Dict[str, int] = {"event_conv_batched": 0,
                            "event_pool_batched": 0,
                            "event_fc_batched": 0}

# (slab in, weights, gate, accumulator out) -> pairing code of the kernels;
# the rows of `core.layer_program.scatter_dtypes`
PAIRINGS = {
    (torch.float32, torch.float32, torch.float32, torch.float32): 0,
    (torch.int8, torch.int8, torch.int8, torch.int32): 1,
    (torch.int32, torch.int8, torch.int32, torch.int32): 2,
}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pairing(name: str, v: torch.Tensor, w: torch.Tensor, gate: torch.Tensor,
            out_dtype: torch.dtype) -> int:
    """The kernels' code for this dtype pairing; raise on any other."""
    key = (v.dtype, w.dtype, gate.dtype, out_dtype)
    if key not in PAIRINGS:
        raise TypeError(
            f"{name}: unsupported dtypes (slab {v.dtype}, weights {w.dtype},"
            f" gate {gate.dtype}, out {out_dtype}); the kernels take "
            f"(f32, f32, f32 -> f32), (int8, int8, int8 -> int32) or "
            f"(int32, int8, int32 -> int32)")
    return PAIRINGS[key]


def check_batch(name: str, v: torch.Tensor, ev_xyc: torch.Tensor,
                ev_gate: torch.Tensor) -> None:
    """Slot and event axes must agree; events are ``(N, E, 3)`` int32."""
    N = v.shape[0]
    if ev_xyc.dim() != 3 or ev_xyc.shape[2] != 3:
        raise ValueError(f"{name}: events must be (N, E, 3), got "
                         f"{tuple(ev_xyc.shape)}")
    if ev_xyc.dtype != torch.int32:
        raise TypeError(f"{name}: events must be int32, got {ev_xyc.dtype}")
    if ev_xyc.shape[0] != N or tuple(ev_gate.shape) != tuple(
            ev_xyc.shape[:2]):
        raise ValueError(
            f"{name}: slot/event axes disagree: slab {tuple(v.shape)}, "
            f"events {tuple(ev_xyc.shape)}, gates {tuple(ev_gate.shape)}")


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """All operands on one CUDA device and contiguous; return the device."""
    dev: Optional[torch.device] = None
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: operand on {t.device}, expected CUDA "
                             f"(the plain version serves CPU tensors only "
                             f"when every operand is on the CPU)")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} is "
                             f"not contiguous")
    return dev


def raise_on_error(name: str, err: int) -> None:
    """Raise if the C launcher reported a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def last_active(ev_gate: torch.Tensor) -> int:
    """One past the last event index any slot gates on (0 if none).

    The plain versions stop there: a gated-off event adds ``w·0``, which
    changes at most the sign of a zero.
    """
    active = (ev_gate != 0).any(dim=0).nonzero()
    return int(active[-1]) + 1 if active.numel() else 0
