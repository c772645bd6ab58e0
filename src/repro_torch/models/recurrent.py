"""RG-LRU recurrent block (RecurrentGemma / Griffin), counterpart of
``repro.models.recurrent``.

The recurrence ``h_t = a_t * h_{t-1} + sqrt(1-a_t^2) * (i_t * x_t)`` is a
gated leaky integrator, the same dynamical family as the SNE paper's LIF
membrane.  Prefill runs it over the whole sequence as a log-depth
doubling scan (:func:`linear_scan`); decode is the O(1) single step.

Gates are per-channel (diagonal) as in Griffin's block-diagonal limit.
The reference ignores the config's ``act`` inside the block and always
gates with gelu (the tanh approximation); so does the port.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import DeclTree, ParamDecl, ParamTree, gelu

_C = 8.0  # Griffin's fixed recurrence sharpness constant


def rglru_decls(d_model: int, d_lru: int, conv_w: int) -> DeclTree:
    return {
        "w_in": ParamDecl((d_model, d_lru), ("p_embed", "p_mlp")),
        "w_gate": ParamDecl((d_model, d_lru), ("p_embed", "p_mlp")),
        "conv_w": ParamDecl((conv_w, d_lru), (None, "p_mlp"),
                          scale=conv_w ** -0.5),
        "conv_b": ParamDecl((d_lru,), ("p_mlp",), init="zeros"),
        "a_w": ParamDecl((d_lru,), ("p_mlp",), scale=1.0),
        "a_b": ParamDecl((d_lru,), ("p_mlp",), init="zeros"),
        "x_w": ParamDecl((d_lru,), ("p_mlp",), scale=1.0),
        "x_b": ParamDecl((d_lru,), ("p_mlp",), init="zeros"),
        "lam": ParamDecl((d_lru,), ("p_mlp",), init="ones"),
        "w_out": ParamDecl((d_lru, d_model), ("p_mlp", "p_embed")),
    }


def _gates(p: ParamTree, xc: torch.Tensor):
    """Per-channel recurrence/input gates on the post-conv signal (f32)."""
    x32 = xc.float()
    r = torch.sigmoid(x32 * p["a_w"] + p["a_b"])
    i = torch.sigmoid(x32 * p["x_w"] + p["x_b"])
    log_a = -_C * F.softplus(p["lam"]) * r               # log a_t  (<= 0)
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably as sqrt(-expm1(2 log a))
    b_scale = torch.sqrt(-torch.expm1(2.0 * log_a))
    b = b_scale * (i * x32)
    return a, b


def conv1d_causal(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, D) with width-W taps (shift-add)."""
    W = w.shape[0]
    out = x * w[W - 1]
    for k in range(1, W):
        shifted = F.pad(x, (0, 0, k, 0))[:, :-k, :]
        out = out + shifted * w[W - 1 - k]
    return out + b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` (``h_{-1} = 0``) along axis 1, by
    recursive doubling: pass ``k`` combines each element with the one
    ``2^k`` before it, ``ceil(log2 S)`` passes in all (12 at S = 3000),
    each a few elementwise kernels over the whole sequence.

    The reference runs ``jax.lax.associative_scan``, whose tree pairs the
    elements in another order; in float32 the two agree to rounding
    (``tests/test_torch_lm.py`` states the tolerance)."""
    S = a.shape[1]
    off = 1
    while off < S:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        if 2 * off < S:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return b


def rglru_scan(p: ParamTree, xc: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the recurrence over (B, S, D). Returns (h_seq, h_last)."""
    a, b = _gates(p, xc)
    if h0 is not None:
        # fold the carried state into the first step's additive term
        b = b.clone()
        b[:, 0, :] += a[:, 0, :] * h0.float()
    h = linear_scan(a, b)
    return h.to(xc.dtype), h[:, -1, :]


def rglru_step(p: ParamTree, xc_t: torch.Tensor,
               h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step. xc_t: (B, D) post-conv input; h: (B, D) state."""
    a, b = _gates(p, xc_t[:, None, :])
    h_new = a[:, 0] * h.float() + b[:, 0]
    return h_new.to(xc_t.dtype), h_new


def rglru_block(p: ParamTree, x: torch.Tensor,
                act=None) -> Tuple[torch.Tensor, Dict]:
    """Full block, prefill mode. x: (B, S, d_model).  ``act`` is ignored
    (gelu always), as in the reference."""
    dt = x.dtype
    x1 = x @ p["w_in"].to(dt)
    gate = gelu(x @ p["w_gate"].to(dt))
    xc = conv1d_causal(x1, p["conv_w"].to(dt), p["conv_b"].to(dt))
    h, h_last = rglru_scan(p, xc)
    out = (h * gate) @ p["w_out"].to(dt)
    state = {"h": h_last.float(),
             "conv": x1[:, -(p["conv_w"].shape[0] - 1):, :]}
    return out, state


def rglru_block_step(p: ParamTree, x_t: torch.Tensor, state: Dict,
                     act=None) -> Tuple[torch.Tensor, Dict]:
    """One decode step. x_t: (B, 1, d_model); state: {h, conv}."""
    dt = x_t.dtype
    x1 = (x_t @ p["w_in"].to(dt))[:, 0]                 # (B, L)
    gate = gelu(x_t @ p["w_gate"].to(dt))[:, 0]
    # causal depthwise conv over the ring of the last W-1 inputs
    w = p["conv_w"].to(dt)
    window = torch.cat([state["conv"], x1[:, None, :]], dim=1)  # (B, W, L)
    xc = torch.einsum("bwl,wl->bl", window, w) + p["conv_b"].to(dt)
    h_out, h_new = rglru_step(p, xc, state["h"])
    out = (h_out * gate) @ p["w_out"].to(dt)
    return out[:, None, :], {"h": h_new, "conv": window[:, 1:, :]}
