"""Declarative parameters and elementary layers (norm, RoPE, activations,
the gated FFN): the counterpart of ``repro.models.layers``.

Parameters are declared once (:class:`ParamDecl`: shape, logical
sharding axes, initializer, dtype) and the declaration tree is consumed
three times: by :func:`init_tree` (random values from a
``torch.Generator``), by the weight converter
(``repro_torch.weights.lm_params_from_numpy``), which checks the
reference's arrays against the same shapes, and by the dry-run
(``repro_torch.launch.specs``), which resolves each leaf's axes to a
partition spec on the production mesh.  The axes are the reference's, less
its leading ``"p_layers"`` entry: the port keeps one entry per layer
where the reference stacks a scan group, and ``"p_layers"`` maps to no
mesh axis.

A declaration tree is a nested ``dict`` whose values are dicts, lists of
trees (one entry per layer) or :class:`ParamDecl` leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]     # logical sharding axes, len == ndim
    init: str = "normal"                # normal | zeros | ones
    scale: Optional[float] = None       # stddev; None -> 1/sqrt(fan_in)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamDecl: shape {self.shape} and axes "
                             f"{self.axes} differ in length")

    def fan_in(self) -> int:
        # convention: last axis is fan-out, the rest multiply to fan-in
        if len(self.shape) == 1:
            return self.shape[0]
        out = 1
        for s in self.shape[:-1]:
            out *= s
        return max(out, 1)

    def instantiate(self, gen: torch.Generator,
                    device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        std = self.scale if self.scale is not None else self.fan_in() ** -0.5
        t = torch.empty(self.shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (t * std).to(self.dtype)


DeclTree = Dict[str, Any]   # nested dict / list of ParamDecl
ParamTree = Dict[str, Any]  # the same nesting, of tensors


def tree_leaves(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """``(path, leaf)`` pairs in a fixed order: dict keys sorted, list
    entries in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, path + (i,))
    else:
        yield path, tree


def tree_unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in
    :func:`tree_leaves` order, by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            new = {k: build(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    return build(tree)


def tree_map(fn: Callable, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def init_tree(gen: torch.Generator, decls: DeclTree,
              device: torch.device) -> ParamTree:
    """Instantiate a declaration tree on ``device``, leaf after leaf from
    one generator (which must live on ``device``).  JAX's per-path keys
    cannot be matched, so the tests carry the reference's weights across
    instead."""
    return tree_map(lambda d: d.instantiate(gen, device), decls)


def count_params(decls: DeclTree) -> int:
    total = 0
    for _, d in tree_leaves(decls):
        n = 1
        for s in d.shape:
            n *= s
        total += n
    return total


# ---------------------------------------------------------------------------
# Elementary layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + w``, back in ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"silu": F.silu, "gelu": gelu, "relu": F.relu}[name]


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding on the split halves (not interleaved pairs), in
    float32. x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq      # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]              # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def sinusoidal_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings of the positions
    ``pos`` (N,) as (N, d) float32: the sines of all ``d // 2``
    frequencies, then their cosines (concatenated, not interleaved)."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    ang = pos.float()[:, None] / (10000.0 ** (2 * dim[None, :] / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """:func:`sinusoidal_at` of positions ``0 .. n-1``: (n, d) float32."""
    return sinusoidal_at(torch.arange(n, device=device), d)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, act: str) -> torch.Tensor:
    """Gated FFN: ``act(x @ Wg) * (x @ Wu) @ Wd`` in ``x``'s dtype."""
    dt = x.dtype
    g = x @ w_gate.to(dt)
    u = x @ w_up.to(dt)
    return (activation(act)(g) * u) @ w_down.to(dt)


def ffn_decls(d_model: int, d_ff: int) -> DeclTree:
    return {
        "gate": ParamDecl((d_model, d_ff), ("p_embed", "p_mlp")),
        "up": ParamDecl((d_model, d_ff), ("p_embed", "p_mlp")),
        "down": ParamDecl((d_ff, d_model), ("p_mlp", "p_embed")),
    }


def ffn_apply(p: ParamTree, x: torch.Tensor, act: str) -> torch.Tensor:
    return swiglu(x, p["gate"], p["up"], p["down"], act)
