"""LIF neuron dynamics (paper §III-B), counterpart of ``repro.core.lif``.

The linearised leaky integrate-and-fire neuron: ``V[t+1] = V[t] - L +
sum_j W_ij S_j[t]``, ``S[t] = Theta(V[t] - V_th)``, a firing reset and an
optional 8-bit state clip.  Every function here is dtype-generic: it runs
in ``v.dtype`` (the float32 carrier or a native int32 accumulator), and
integer callers hold integral leak / threshold (`core.quant` lowers them
so).  The arithmetic is operation for operation the reference's, so float
results are bitwise equal.

The dense training path adds :func:`spike_fn` (the Heaviside fire with a
fast-sigmoid surrogate gradient), :func:`lif_step` and :func:`lif_rollout`;
their gradients follow the reference's ``jax.grad`` conventions, ties
included (see :func:`lif_step`).
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
    ``jnp.asarray(x, v.dtype)``); a Python number is filled in on the
    device, not copied there (a copy would wait on the stream)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=like.dtype)
    return torch.full((), x, dtype=like.dtype, device=like.device)


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


class _SpikeFn(torch.autograd.Function):
    """Heaviside forward, fast-sigmoid surrogate backward."""

    @staticmethod
    def forward(ctx, v, threshold: float, beta: float):
        ctx.save_for_backward(v)
        ctx.threshold, ctx.beta = threshold, beta
        return (v >= threshold).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        x = torch.abs(v - ctx.threshold) * ctx.beta
        # a tensor numerator: ``float / tensor`` is reciprocal-then-multiply
        # in torch, two roundings where the reference has one
        surr = _scalar(ctx.beta, x) / (2.0 * (1.0 + x) ** 2)
        return g * surr, None, None


def spike_fn(v: torch.Tensor, threshold: float, beta: float = 10.0
             ) -> torch.Tensor:
    """Heaviside firing rule with a fast-sigmoid surrogate gradient.

    Forward: ``(v >= threshold)`` in ``v.dtype``.  Backward: ``g · β /
    (2(1 + β|v − th|)²)``, the reference's custom VJP; threshold and β are
    plain numbers and get no gradient.
    """
    return _SpikeFn.apply(v, threshold, beta)


def _clip(v: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.clip(v, -c, c)`` as min(max(·)): a value on a bound passes
    half its gradient, as JAX's does (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(v, _scalar(-c, v)), _scalar(c, v))


def lif_step(v: torch.Tensor, syn_in: torch.Tensor, p: LifParams,
             train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dense LIF timestep: leak -> integrate -> clip -> fire -> reset.

    Returns ``(v_next, spikes)``.  ``train=True`` routes the threshold
    through :func:`spike_fn`; the reset ``v·(1 − s)`` keeps the gradient
    through ``s`` as the reference does.  Ties split their gradient as
    ``jax.grad`` does: ``torch.maximum`` in the leak and :func:`_clip`;
    ``|v|``'s derivative at 0 differs (torch 0, JAX 1) but is multiplied
    by ``sign(0) = 0``.
    """
    v = apply_leak(v, p.leak, 1, p.leak_mode)
    v = v + syn_in
    if p.state_clip is not None:
        v = _clip(v, p.state_clip)
    if train:
        s = spike_fn(v, p.threshold, p.surrogate_beta)
    else:
        s = (v >= p.threshold).to(v.dtype)
    if p.reset_mode == "zero":
        v = v * (1.0 - s)
    else:
        v = v - s * p.threshold
    return v, s


def lif_rollout(v0: torch.Tensor, syn_in: torch.Tensor, p: LifParams,
                train: bool = False, time_dim: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`lif_step` over the ``time_dim`` axis of ``syn_in`` (the
    reference's ``lax.scan``; axis 0 there).  Returns ``(v_final,
    spikes)`` with the spikes stacked on ``time_dim``."""
    v, out = v0, []
    for x in syn_in.unbind(time_dim):
        v, s = lif_step(v, x, p, train)
        out.append(s)
    return v, torch.stack(out, time_dim)


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
