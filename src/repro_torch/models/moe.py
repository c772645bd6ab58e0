"""Mixture-of-Experts with gather-based static-capacity dispatch,
counterpart of ``repro.models.moe`` (its ``moe_apply``).

Top-k routing is the LM-scale form of the paper's energy-proportional
principle: compute follows the routed "token events", and the static
expert capacity plays the part of SNE's event FIFO — overflow tokens are
dropped and counted (``MoeStats.dropped_frac``).

Each expert gathers its top-C tokens by router weight, runs a dense
per-expert GEMM batch ``(E, C, d)``, and the results are added back,
weighted by the router probability.  Two choices decide which tokens an
expert keeps, and the port makes both as the reference does:

* **Ties.** ``jax.lax.top_k`` puts the lower index first among equal
  values; ``torch.topk`` promises no order.  Both top-k choices (a token's
  experts, an expert's tokens) are a stable descending sort cut to its
  first K or C.  With ``top_k = 1`` every routed gate is exactly 1.0, so on
  overflow an expert keeps its lowest token indices.
* **The combine** adds each token's experts in expert order in float32:
  one ``index_add_`` per expert.  An expert's C indices are distinct, so no
  address takes two adds in one launch and the sum repeats bitwise on the
  card, where ``index_add_`` uses atomics.

The expert-parallel ``shard_map`` dispatch of the reference waits for the
rest of ``distributed/`` (ROADMAP Queue A, LM substrate item 6).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.models.layers import (DeclTree, ParamDecl, ParamTree,
                                       activation, swiglu)


class MoeStats(NamedTuple):
    aux_loss: torch.Tensor       # load-balance auxiliary loss
    dropped_frac: torch.Tensor   # fraction of (token, expert) routes dropped


def zero_stats(device=None) -> MoeStats:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return MoeStats(aux_loss=z, dropped_frac=z)


def moe_decls(d_model: int, n_experts: int, expert_ff: int,
              shared: bool, d_ff: int) -> DeclTree:
    d: DeclTree = {
        "router": ParamDecl((d_model, n_experts), scale=d_model ** -0.5),
        "gate": ParamDecl((n_experts, d_model, expert_ff)),
        "up": ParamDecl((n_experts, d_model, expert_ff)),
        "down": ParamDecl((n_experts, expert_ff, d_model)),
    }
    if shared:
        d["shared"] = {
            "gate": ParamDecl((d_model, d_ff)),
            "up": ParamDecl((d_model, d_ff)),
            "down": ParamDecl((d_ff, d_model)),
        }
    return d


def _capacity(n_tokens: int, n_experts: int, top_k: int,
              factor: float) -> int:
    c = int(n_tokens * top_k * factor / n_experts)
    c = max(8, -(-c // 8) * 8)  # round up to 8 (sublane alignment)
    return min(c, n_tokens)     # decode: can't gather more than T tokens


def _top(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row and their indices, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, xf: torch.Tensor,
          top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router probabilities (T, E) of tokens xf (T, d), in float32, and the
    selection ``sel`` (T, E): each token's normalised gate at its top_k
    experts, 0 elsewhere."""
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = _top(probs, top_k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    sel = torch.zeros_like(probs).scatter_(1, top_i, top_p)
    return probs, sel


def dispatch(sel: torch.Tensor, capacity: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each expert's top-``capacity`` tokens by gate.  Returns the gates
    (E, C) (0 where a slot holds no routed token), the token indices (E, C)
    and ``valid`` (E, C) float32, 1 where the slot holds a routed token:
    the kept (expert, token) pairs."""
    scores = torch.where(sel.T > 0, sel.T, -1.0)           # (E, T)
    gate_ec, idx_ec = _top(scores, capacity)
    valid = (gate_ec > 0).float()
    return gate_ec * valid, idx_ec, valid


def moe_apply(p: ParamTree, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float, act: str,
              shared: bool) -> Tuple[torch.Tensor, MoeStats]:
    """x: (B, S, d) -> (B, S, d) in x's dtype, and the layer's stats."""
    B, S, d = x.shape
    T = B * S
    E = n_experts
    C = _capacity(T, E, top_k, capacity_factor)
    xf = x.reshape(T, d)
    probs, sel = route(p["router"], xf, top_k)
    gate_ec, idx_ec, valid = dispatch(sel, C)

    # gather -> expert FFN -> weighted combine, expert after expert
    dt = x.dtype
    xe = xf.index_select(0, idx_ec.reshape(-1)).reshape(E, C, d)
    g = torch.bmm(xe, p["gate"].to(dt))
    u = torch.bmm(xe, p["up"].to(dt))
    ye = torch.bmm(activation(act)(g) * u, p["down"].to(dt))
    ye = (ye * gate_ec[..., None].to(dt)).float()
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for e in range(E):
        out.index_add_(0, idx_ec[e], ye[e])
    out = out.to(dt).reshape(B, S, d)
    if shared:
        sp = p["shared"]
        out = out + swiglu(x, sp["gate"], sp["up"], sp["down"], act)

    # Switch-style aux loss and capacity-drop accounting
    routed = sel > 0
    aux = E * torch.sum(routed.float().mean(0) * probs.mean(0))
    n_routes = routed.sum().float()
    dropped = 1.0 - valid.sum() / torch.clamp(n_routes, min=1.0)
    return out, MoeStats(aux_loss=aux, dropped_frac=dropped)
