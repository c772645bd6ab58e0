"""Plain PyTorch version of the fused LIF boundary.

Counterpart of ``repro.kernels.lif.ref.lif_fused_ref`` and the twin of
``csrc/lif_fused.cu``: one FIRE boundary of the SNE execution model,
elementwise over the membrane tensor,

  1. lazy leak: ``dt`` toward-zero leak steps at once,
     ``sign(v) * max(|v| - leak * dt, 0)``;
  2. integrate the synaptic input: ``v + syn``;
  3. saturate to ``±state_clip`` (when given);
  4. threshold: ``s = v >= threshold``;
  5. hard reset: ``v * (1 - s)``.

Every step is one correctly rounded float32 operation, as in the
reference, so the results are bitwise its results.
"""
from __future__ import annotations

from typing import Optional

import torch


def lif_fused_ref(v: torch.Tensor, syn: torch.Tensor, dt, leak: float,
                  threshold: float, state_clip: Optional[float] = None):
    """Returns ``(v_next, spikes)``, both in ``v.dtype``; spikes in {0, 1}."""
    def f(x):
        return torch.as_tensor(x, dtype=v.dtype, device=v.device)

    step = f(leak) * f(dt)
    v = torch.sign(v) * torch.maximum(torch.abs(v) - step, f(0.0))
    v = v + syn
    if state_clip is not None:
        v = torch.clamp(v, -f(state_clip), f(state_clip))
    s = (v >= f(threshold)).to(v.dtype)
    return v * (1 - s), s
