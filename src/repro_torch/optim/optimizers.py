"""AdamW and momentum SGD as plain functions on lists of tensors.

Counterpart of ``repro.optim.optimizers``, with its arithmetic in its
order: the global-norm clip first, then ``mu·b1 + g·(1 − b1)``,
``nu·b2 + g²·(1 − b2)``, the bias corrections, ``delta = mhat / (sqrt(nhat)
+ eps) + wd·p`` and ``p − lr·delta``, the moments updated in float32 and
stored back in their own dtype; the step counter is int32 and the
learning rate a float32 tensor.  (``torch.optim.AdamW`` decays before the
moment step: a different recipe.)  Updates run without autograd and return
new tensors; nothing is updated in place.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.optim.schedules import _f32


class AdamWState(NamedTuple):
    """Step counter (int32) and the first and second moments."""

    step: torch.Tensor
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class SgdState(NamedTuple):
    """Step counter (int32) and the momentum buffers."""

    step: torch.Tensor
    velocity: List[torch.Tensor]


def _global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in grads))


@torch.no_grad()
def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float
                        ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-9))``;
    returns ``(clipped, norm)``."""
    norm = _global_norm(grads)
    scale = torch.minimum(_f32(1.0, norm), _f32(max_norm, norm)
                          / torch.maximum(norm, _f32(1e-9, norm)))
    return [(g.to(torch.float32) * scale).to(g.dtype) for g in grads], norm


def adamw_init(params: Sequence[torch.Tensor],
               moment_dtype: torch.dtype = torch.float32) -> AdamWState:
    """Zero moments in ``moment_dtype`` (float32 by default; bfloat16 for
    the configs whose float32 moments would not fit) and step 0."""
    dev = params[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=[torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
            for p in params],
        nu=[torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
            for p in params])


@torch.no_grad()
def adamw_update(grads: Sequence[torch.Tensor], state: AdamWState,
                 params: Sequence[torch.Tensor], lr: torch.Tensor, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 max_grad_norm: Optional[float] = 1.0
                 ) -> Tuple[List[torch.Tensor], AdamWState,
                            Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns ``(new_params, new_state, {"grad_norm"})``
    (the norm before clipping)."""
    if max_grad_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    else:
        gnorm = _global_norm(grads)
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(b1, t), t)
    bc2 = 1.0 - torch.pow(_f32(b2, t), t)
    new_p, new_mu, new_nu = [], [], []
    for p, g, mu, nu in zip(params, grads, state.mu, state.nu):
        g32 = g.to(torch.float32)
        mu32 = mu.to(torch.float32) * b1 + g32 * (1.0 - b1)
        nu32 = nu.to(torch.float32) * b2 + torch.square(g32) * (1.0 - b2)
        mhat = mu32 / bc1
        nhat = nu32 / bc2
        delta = (mhat / (torch.sqrt(nhat) + eps)
                 + weight_decay * p.to(torch.float32))
        new_p.append((p.to(torch.float32) - lr * delta).to(p.dtype))
        new_mu.append(mu32.to(mu.dtype))
        new_nu.append(nu32.to(nu.dtype))
    return new_p, AdamWState(step, new_mu, new_nu), {"grad_norm": gnorm}


def sgd_init(params: Sequence[torch.Tensor]) -> SgdState:
    """Zero velocities and step 0."""
    return SgdState(step=torch.zeros((), dtype=torch.int32,
                                     device=params[0].device),
                    velocity=[torch.zeros_like(p) for p in params])


@torch.no_grad()
def sgd_update(grads: Sequence[torch.Tensor], state: SgdState,
               params: Sequence[torch.Tensor], lr: torch.Tensor, *,
               momentum: float = 0.9):
    """One momentum-SGD step: ``v = momentum·v + g``, ``p − lr·v``.
    Returns ``(new_params, new_state, {})``."""
    vel = [momentum * v + g for v, g in zip(state.velocity, grads)]
    new_params = [p - lr * v for p, v in zip(params, vel)]
    return new_params, SgdState(state.step + 1, vel), {}
