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

:func:`moe_apply_shardmap` is the reference's expert-parallel dispatch
over a mesh (`distributed.mesh.Mesh`): each token shard routes its own
tokens under a per-shard capacity, one ``all_to_all`` over "model" sends
them to their experts' shards and one brings the results back.  It runs
on shard lists (`distributed.collectives`), so autograd runs through it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import PartitionSpec as P
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
        "router": ParamDecl((d_model, n_experts), ("p_embed", None),
                            scale=d_model ** -0.5),
        "gate": ParamDecl((n_experts, d_model, expert_ff),
                          ("p_experts", "p_embed", "p_mlp")),
        "up": ParamDecl((n_experts, d_model, expert_ff),
                        ("p_experts", "p_embed", "p_mlp")),
        "down": ParamDecl((n_experts, expert_ff, d_model),
                          ("p_experts", "p_mlp", "p_embed")),
    }
    if shared:
        d["shared"] = {
            "gate": ParamDecl((d_model, d_ff), ("p_embed", "p_mlp")),
            "up": ParamDecl((d_model, d_ff), ("p_embed", "p_mlp")),
            "down": ParamDecl((d_ff, d_model), ("p_mlp", "p_embed")),
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
    xe = xf.index_select(0, idx_ec.reshape(-1)).reshape(E, C, d)
    ye = _experts(xe, p["gate"], p["up"], p["down"], act)
    out = _combine(ye, gate_ec, idx_ec, T).reshape(B, S, d)
    if shared:
        out = out + _shared(p, x, act)
    return out, _stats(probs, sel, valid)


def _experts(xe: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
             down: torch.Tensor, act: str) -> torch.Tensor:
    """The expert FFN batch: (E, C, d) -> (E, C, d) in xe's dtype."""
    dt = xe.dtype
    g = torch.bmm(xe, gate.to(dt))
    u = torch.bmm(xe, up.to(dt))
    return torch.bmm(activation(act)(g) * u, down.to(dt))


def _combine(ye: torch.Tensor, gate_ec: torch.Tensor, idx_ec: torch.Tensor,
             T: int) -> torch.Tensor:
    """The gate-weighted expert outputs added back to their T tokens in
    float32, expert after expert; (T, d) in ye's dtype."""
    dt = ye.dtype
    ye = (ye * gate_ec[..., None].to(dt)).float()
    out = torch.zeros((T, ye.shape[-1]), dtype=torch.float32,
                      device=ye.device)
    for e in range(ye.shape[0]):
        out.index_add_(0, idx_ec[e], ye[e])
    return out.to(dt)


def _shared(p: ParamTree, x: torch.Tensor, act: str) -> torch.Tensor:
    sp = p["shared"]
    return swiglu(x, sp["gate"], sp["up"], sp["down"], act)


def _stats(probs: torch.Tensor, sel: torch.Tensor,
           valid: torch.Tensor) -> MoeStats:
    """Switch-style aux loss and capacity-drop accounting."""
    routed = sel > 0
    aux = probs.shape[1] * torch.sum(routed.float().mean(0) * probs.mean(0))
    n_routes = routed.sum().float()
    dropped = 1.0 - valid.sum() / torch.clamp(n_routes, min=1.0)
    return MoeStats(aux_loss=aux, dropped_frac=dropped)


def moe_apply_shardmap(p: ParamTree, x: torch.Tensor, *, n_experts: int,
                       top_k: int, capacity_factor: float, act: str,
                       shared: bool, mesh, model_axis: str = "model",
                       seq_shard: bool = False
                       ) -> Tuple[torch.Tensor, MoeStats]:
    """Expert-parallel MoE over ``mesh``: local routing and an all-to-all
    dispatch (the reference's ``moe_apply_shardmap``).

    Tokens shard over the data axes ("pod", "data"), and over
    ``model_axis`` too under ``seq_shard``; experts shard over
    ``model_axis``, their d axis FSDP-split over "data" and gathered back
    first.  Each shard routes its own ``T_local`` tokens under the
    capacity of ``T_local``; rows for expert set ``j`` travel to model rank
    ``j`` and back.  ``aux_loss`` and ``dropped_frac`` are the mean of the
    shards'.  Where the experts, the batch or (under ``seq_shard``) the
    sequence do not divide, it is ``moe_apply``.  The shared expert runs
    outside the shards."""
    B, S, d = x.shape
    E, K = n_experts, top_k
    n_model = mesh.shape[model_axis]
    data_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    n_data = math.prod(mesh.shape[a] for a in data_axes)
    if E % n_model or B % n_data or (seq_shard and S % n_model):
        return moe_apply(p, x, n_experts=E, top_k=K,
                         capacity_factor=capacity_factor, act=act,
                         shared=shared)
    T_local = (B // n_data) * (S // (n_model if seq_shard else 1))
    C = _capacity(T_local, E, K, capacity_factor)
    fs = "data" if "data" in mesh.shape else None
    d_ax = data_axes if len(data_axes) > 1 else (
        data_axes[0] if data_axes else None)
    batch_spec = P(d_ax, model_axis if seq_shard else None, None)

    xs = col.split(x, batch_spec, mesh)
    router = col.split(p["router"], P(None, None), mesh)
    gate = col.split(p["gate"], P(model_axis, fs, None), mesh)
    up = col.split(p["up"], P(model_axis, fs, None), mesh)
    down = col.split(p["down"], P(model_axis, None, fs), mesh)
    if fs is not None:      # the FSDP gather of each shard's experts
        gate = col.all_gather(gate, fs, 1, mesh)
        up = col.all_gather(up, fs, 1, mesh)
        down = col.all_gather(down, fs, 2, mesh)

    # per shard: route, keep the top-C tokens of every expert, gather them
    xf = [xb.reshape(-1, d) for xb in xs]
    routed = [route(r, t, K) for r, t in zip(router, xf)]
    kept = [dispatch(sel, C) for _, sel in routed]
    xe = [t.index_select(0, idx.reshape(-1)).reshape(E, C, d)
          for t, (_, idx, _) in zip(xf, kept)]
    if n_model > 1:
        xe = col.all_to_all(xe, model_axis, 0, 1, mesh)
    # xe: (E / n_model, C * n_model, d), this shard's experts, every shard
    ye = [_experts(a, g, u, w, act)
          for a, g, u, w in zip(xe, gate, up, down)]
    if n_model > 1:
        ye = col.all_to_all(ye, model_axis, 1, 0, mesh)
    outs = [_combine(y, g, idx, t.shape[0]).reshape(xb.shape)
            for y, (g, idx, _), t, xb in zip(ye, kept, xf, xs)]
    stats = [_stats(probs, sel, valid)
             for (probs, sel), (_, _, valid) in zip(routed, kept)]
    aux = [s.aux_loss for s in stats]
    dropped = [s.dropped_frac for s in stats]
    mean_axes = data_axes + ((model_axis,) if seq_shard else ())
    if mean_axes:
        aux = col.pmean(aux, mean_axes, mesh)
        dropped = col.pmean(dropped, mean_axes, mesh)

    out = col.join(outs, batch_spec, mesh)
    if shared:
        out = out + _shared(p, x, act)
    return out, MoeStats(aux_loss=col.join(aux, P(), mesh),
                         dropped_frac=col.join(dropped, P(), mesh))
