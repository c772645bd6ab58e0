"""Sigma-delta event coding for LM decode, counterpart of
``repro.core.lm_events``.

SNE's core insight is that state updates should cost only when
information arrives.  For the recurrent archs (recurrentgemma's RG-LRU),
decode-time inputs are temporally smooth, so the same idea applies per
channel:

  * keep a **reference** of the last transmitted value per channel;
  * a channel emits an "event" only when ``|x - ref|`` reaches a threshold
    theta; the others reuse the reference;
  * event counts are the LM analogue of the paper's SOP counts, and feed
    the same energy model (:func:`decode_energy_estimate`, the paper's
    0.221 pJ/SOP).

:func:`activation_events` counts would-be events of a dense activation,
for archs where the technique itself does not apply.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.models.recurrent import rglru_step


class SigmaDelta(NamedTuple):
    """Per-channel reference state for sigma-delta gating."""
    ref: torch.Tensor


def sd_init(x0: torch.Tensor) -> SigmaDelta:
    """Zero reference state shaped like the first activation."""
    return SigmaDelta(ref=torch.zeros_like(x0, dtype=torch.float32))


def sd_encode(sd: SigmaDelta, x: torch.Tensor, threshold: float
              ) -> Tuple[torch.Tensor, SigmaDelta, torch.Tensor]:
    """Gate ``x`` against the reference.

    Returns ``(x_eff, new_state, events)``: ``x_eff`` equals ``x`` on
    emitting channels and the old reference elsewhere, ``events`` is the
    per-element emission mask."""
    x32 = x.float()
    fire = (x32 - sd.ref).abs() >= threshold
    new_ref = torch.where(fire, x32, sd.ref)
    return new_ref.to(x.dtype), SigmaDelta(ref=new_ref), fire


def sd_event_rate(fires: torch.Tensor) -> torch.Tensor:
    """Fraction of channels that emitted (the activity metric)."""
    return fires.float().mean()


def activation_events(h: torch.Tensor,
                      threshold: float = 0.0) -> torch.Tensor:
    """Would-be event count of a dense activation tensor."""
    return (h.float().abs() > threshold).sum()


def gated_rglru_step(p: Dict, xc_t: torch.Tensor, h: torch.Tensor,
                     sd: SigmaDelta, threshold: float):
    """RG-LRU decode step on the sigma-delta-gated input; with
    threshold = 0 it is exactly the ungated step.  Returns
    ``(h_out, h_new, sd_new, event_frac)``."""
    x_eff, sd_new, fires = sd_encode(sd, xc_t, threshold)
    h_out, h_new = rglru_step(p, x_eff, h)
    return h_out, h_new, sd_new, sd_event_rate(fires)


def decode_energy_estimate(event_frac: float, d_state: int, n_layers: int,
                           n_tokens: int,
                           pj_per_sop: float = 0.221) -> Dict[str, float]:
    """Map LM event counts onto the paper's energy model: each emitted
    channel event triggers about ``d_state`` synaptic-op equivalents of
    state update work, at the paper's measured 0.221 pJ/SOP."""
    sops = event_frac * d_state * d_state * n_layers * n_tokens
    return {
        "sops": sops,
        "energy_j": sops * pj_per_sop * 1e-12,
        "energy_per_token_j": sops * pj_per_sop * 1e-12 / max(n_tokens, 1),
    }
