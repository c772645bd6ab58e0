"""LIF neuron dynamics (paper §III-B), counterpart of ``repro.core.lif``.

The linearised leaky integrate-and-fire neuron: ``V[t+1] = V[t] - L +
sum_j W_ij S_j[t]``, ``S[t] = Theta(V[t] - V_th)``, a firing reset and an
optional 8-bit state clip.  Every function here is dtype-generic: it runs
in ``v.dtype`` (the float32 carrier or a native int32 accumulator), and
integer callers hold integral leak / threshold (`core.quant` lowers them
so).  The arithmetic is operation for operation the reference's, so float
results are bitwise equal.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class LifParams:
    """The linearised LIF plan: threshold, leak, reset, 8-bit clip."""

    threshold: float = 1.0
    leak: float = 0.0625
    leak_mode: str = "toward_zero"   # or "subtract"
    reset_mode: str = "zero"         # or "subtract" (soft reset)
    state_clip: float | None = None  # e.g. 127/scale for 8-bit state
    surrogate_beta: float = 10.0     # steepness of the surrogate gradient

    def __post_init__(self):
        if self.leak < 0:
            raise ValueError("event path requires leak >= 0")
        if self.threshold <= 0:
            raise ValueError("event path requires threshold > 0")
        if self.leak_mode not in ("toward_zero", "subtract"):
            raise ValueError(f"unknown leak mode {self.leak_mode!r}")
        if self.reset_mode not in ("zero", "subtract"):
            raise ValueError(f"unknown reset mode {self.reset_mode!r}")


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor of ``like``'s dtype and device (the reference's
    ``jnp.asarray(x, v.dtype)``)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=like.dtype)
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def apply_leak(v: torch.Tensor, leak, dt: Union[int, float, torch.Tensor],
               mode: str) -> torch.Tensor:
    """Apply ``dt`` leak steps at once (TLU lazy leak — exact).

    ``"toward_zero"`` keeps the reference's ``sign(v)·max(|v|−step, 0)``
    form, including its −0.0 results; ``"subtract"`` is ``v − step``.
    """
    step = _scalar(leak, v) * _scalar(dt, v)
    if mode == "toward_zero":
        return torch.sign(v) * torch.maximum(torch.abs(v) - step,
                                             _scalar(0, v))
    if mode == "subtract":
        return v - step
    raise ValueError(f"unknown leak mode {mode!r}")


def fire_and_reset(v: torch.Tensor, p: LifParams
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FIRE_OP: threshold every neuron, emit spikes, reset firing neurons.

    Returns ``(v_next, spikes)`` with spikes in ``v.dtype`` (0/1).
    """
    th = _scalar(p.threshold, v)
    s = (v >= th).to(v.dtype)
    if p.reset_mode == "zero":
        v = v * (1 - s)
    else:
        v = v - s * th
    return v, s


def supports_idle_skip(p: LifParams) -> bool:
    """Whether input-free timesteps collapse exactly (hard reset only)."""
    return p.reset_mode == "zero"


def idle_decay(v: torch.Tensor, p: LifParams, dt) -> torch.Tensor:
    """Advance a membrane through ``dt`` input-free timesteps in one shot.

    ``dt`` may be a scalar or a tensor broadcastable against ``v`` (the
    engine passes ``(N, 1, 1, 1)``); entries with ``dt == 0`` return the
    state bit-identical.
    """
    if not supports_idle_skip(p):
        raise ValueError("idle_decay requires reset_mode='zero' (soft-reset "
                         "neurons can fire without input; step them densely)")
    dt_t = dt if isinstance(dt, torch.Tensor) else torch.as_tensor(
        dt, device=v.device)
    out = apply_leak(v, p.leak, dt_t, p.leak_mode)
    if p.state_clip is not None:
        c = _scalar(p.state_clip, v)
        out = torch.clamp(out, -c, c)
    return torch.where(dt_t > 0, out, v)
