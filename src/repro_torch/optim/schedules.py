"""Learning-rate schedules: pure functions of the int32 step counter.

Counterpart of ``repro.optim.schedules``.  Each returns a float32 tensor on
the step's device, so reading the schedule never waits on the card;
divisors are float32 tensors, as the reference divides.
"""
from __future__ import annotations

import math

import torch


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 tensor on ``like``'s device: dividing by a Python
    number is a multiply by its reciprocal on the card, not a division."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def constant(lr: float):
    return lambda step: _f32(lr, step)


def linear_warmup(lr: float, warmup_steps: int):
    def f(step):
        s = step.to(torch.float32)
        return lr * torch.minimum(_f32(1.0, s),
                                  (s + 1.0) / _f32(max(warmup_steps, 1), s))
    return f


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        s = torch.minimum(step.to(torch.float32), _f32(total_steps, step))
        cos = 0.5 * (1.0 + torch.cos(math.pi * s
                                     / _f32(max(total_steps, 1), s)))
        return lr * (final_frac + (1.0 - final_frac) * cos)
    return f


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def f(step):
        s = step.to(torch.float32)
        warm = (s + 1.0) / _f32(max(warmup_steps, 1), s)
        post = torch.maximum(s - warmup_steps, _f32(0.0, s))
        denom = _f32(max(total_steps - warmup_steps, 1), s)
        cos = 0.5 * (1.0 + torch.cos(
            math.pi * torch.minimum(post / denom, _f32(1.0, s))))
        decay = final_frac + (1.0 - final_frac) * cos
        return lr * torch.where(s < warmup_steps, warm, decay)
    return f
