"""What the kernel wrappers share: launch counts, the dtype pairings the
kernels take, and the checks made before a launch."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.window_common import (pad_empty_schedule,
                                               window_acc_dtype)

# one count per CUDA kernel; a wrapper adds one where it launches its
# kernel and nowhere else (the plain path and empty batches add nothing)
LAUNCHES: Dict[str, int] = {"event_conv_batched": 0,
                            "event_pool_batched": 0,
                            "event_fc_batched": 0,
                            "event_conv_window": 0,
                            "event_pool_window": 0,
                            "event_fc_window": 0,
                            "network_window": 0,
                            "lif_fused": 0}

# (slab in, weights, gate, accumulator out) -> pairing code of the kernels;
# the rows of `core.layer_program.scatter_dtypes`
PAIRINGS = {
    (torch.float32, torch.float32, torch.float32, torch.float32): 0,
    (torch.int8, torch.int8, torch.int8, torch.int32): 1,
    (torch.int32, torch.int8, torch.int32, torch.int32): 2,
}


# the fused window kernels' pairings: (slab, weights, gate, accumulator) ->
# code; the gate rides at the accumulator dtype, as the reference's
# ``gate4 = ev_gate.astype(acc_dt)``
WINDOW_PAIRINGS = {
    (torch.float32, torch.float32, torch.float32, torch.float32): 0,
    (torch.int8, torch.int8, torch.int32, torch.int32): 1,
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


def window_pairing(name: str, v: torch.Tensor, w: torch.Tensor,
                   gate: torch.Tensor, acc: torch.dtype) -> int:
    """The window kernels' code for this dtype pairing; raise on any other."""
    key = (v.dtype, w.dtype, gate.dtype, acc)
    if key not in WINDOW_PAIRINGS:
        raise TypeError(
            f"{name}: unsupported dtypes (slab {v.dtype}, weights {w.dtype},"
            f" gate {gate.dtype}, accumulator {acc}); the window kernels "
            f"take (f32, f32, f32 -> f32) or (int8, int8, int32 -> int32)")
    return WINDOW_PAIRINGS[key]


def window_schedule(name: str, v: torch.Tensor, ev_xyc: torch.Tensor,
                    ev_gate: torch.Tensor, alive: torch.Tensor,
                    native: bool):
    """Check and normalise a window schedule: ``(N, T, E, 3)`` int32
    events, ``(N, T, E)`` gates and ``(N, T)`` liveness on the slab's slot
    axis.  A zero-length event axis becomes one gated-off event (the
    window still leaks and fires), gates ride at the accumulator dtype and
    liveness at float32.  Returns ``(acc, ev_xyc, ev_gate, alive)``."""
    acc = window_acc_dtype(v.dtype, native)
    ev_xyc, ev_gate = pad_empty_schedule(ev_xyc, ev_gate)
    ev_gate = ev_gate.to(acc)
    alive = alive.to(torch.float32)
    N = v.shape[0]
    if ev_xyc.dim() != 4 or ev_xyc.shape[3] != 3:
        raise ValueError(f"{name}: events must be (N, T, E, 3), got "
                         f"{tuple(ev_xyc.shape)}")
    if ev_xyc.dtype != torch.int32:
        raise TypeError(f"{name}: events must be int32, got {ev_xyc.dtype}")
    if ev_xyc.shape[0] != N or tuple(ev_gate.shape) != tuple(
            ev_xyc.shape[:3]) or tuple(alive.shape) != tuple(
            ev_xyc.shape[:2]):
        raise ValueError(
            f"{name}: slot/time/event axes disagree: slab {tuple(v.shape)}, "
            f"events {tuple(ev_xyc.shape)}, gates {tuple(ev_gate.shape)}, "
            f"alive {tuple(alive.shape)}")
    return acc, ev_xyc, ev_gate, alive


def check_tiles(name: str, tiles, lif, N: int, grid) -> None:
    """An explicit bitmap needs a hard-reset layer and the interior's
    ``(N, nTx, nTy)`` grid."""
    if tiles is None:
        return
    if lif.reset_mode != "zero":
        raise ValueError(
            f"{name}: tile sparsity requires a hard-reset layer "
            f"(reset_mode='zero'): cold-tile decay has no closed form under "
            f"soft reset")
    if tuple(tiles.shape) != (N, grid[0], grid[1]):
        raise ValueError(f"{name}: tiles shape {tuple(tiles.shape)} != "
                         f"{(N, grid[0], grid[1])}")


def lif_args(lif):
    """The LIF plan as the window launchers take it: threshold, leak,
    clip (floats), then leak mode, reset mode, has-clip (ints)."""
    return (float(lif.threshold), float(lif.leak),
            float(0.0 if lif.state_clip is None else lif.state_clip),
            0 if lif.leak_mode == "toward_zero" else 1,
            0 if lif.reset_mode == "zero" else 1,
            int(lif.state_clip is not None))


def on_cpu(*tensors) -> bool:
    """Whether every given tensor (None skipped) lies on the CPU: the one
    case in which a wrapper runs its plain version."""
    return all(t.device.type == "cpu" for t in tensors if t is not None)


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
