"""Low-bit weight storage for LM decode, counterpart of
``repro.models.quant_lm`` (the paper's 4-bit synapse storage, §III-D4,
carried over to the LM substrate).

Decode reads every weight once a token, so storing the weights as int8
codes with per-output-column scales halves the bytes it reads.  A
quantised leaf ``W (.., n)`` becomes ``{"__q": int8 codes, "__s": float32
(n,) scale}``; :func:`dequant_params` rebuilds the float tree in front of
the step function, so the model code is untouched (the reference's
dry-run decodes the same way).

The scale of a leaf is its amax over every axis but the last, over 127.
The reference stacks a scan group's layers (and an expert stack's
experts) along leading axes, so its scales are shared by every layer of
a scan group.  The port keeps one entry per layer; :func:`quantize_model`
shares each scale over the same layers (``cfg.scan_groups()`` and the
position in the cycle), so its codes and scales equal the reference's
bitwise, and :func:`quantize_params` is the leaf-by-leaf form.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamDecl

Q_KEY, S_KEY = "__q", "__s"
_FLOATS = (torch.bfloat16, torch.float32, torch.float16)


def _quantizable(d: ParamDecl) -> bool:
    return len(d.shape) >= 2 and d.dtype in _FLOATS


def _q_decl(d: ParamDecl) -> dict:
    return {Q_KEY: dataclasses.replace(d, dtype=torch.int8),
            S_KEY: ParamDecl((d.shape[-1],), (d.axes[-1],), init="ones",
                             dtype=torch.float32)}


def _map(fn, tree, leaf):
    if leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v, leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, leaf) for v in tree]
    return tree


def quantize_decls(decls: Any) -> Any:
    """ParamDecl tree -> the same tree with int8 storage for every weight
    matrix (every float leaf of two or more axes)."""
    return _map(lambda d: _q_decl(d) if _quantizable(d) else d, decls,
                lambda x: isinstance(x, ParamDecl))


def is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x) == {Q_KEY, S_KEY}


def dequant_params(tree: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """The float tree back from a quantised one: ``q.to(dtype) *
    s.to(dtype)`` leaf by leaf; other leaves unchanged."""
    return _map(lambda n: n[Q_KEY].to(dtype) * n[S_KEY].to(dtype), tree,
                is_qleaf)


def column_amax(w: torch.Tensor) -> torch.Tensor:
    """|w|'s maximum over every axis but the last, float32 (n,)."""
    a = w.float().abs()
    return a.amax(dim=tuple(range(w.ndim - 1))) if w.ndim > 1 else a


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    # a tensor divisor: the card divides correctly rounded, as the
    # reference does, where a Python-number divisor becomes a multiply
    return torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)


def codes_of(w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 codes of ``w`` at ``scale`` (round half to even, clip 127)."""
    return torch.clamp(torch.round(w.float() / scale), -127, 127).to(
        torch.int8)


def _quantize_shared(ws: List[torch.Tensor]) -> List[dict]:
    """Quantise leaves that share one scale (the layers of a stack)."""
    amax = column_amax(ws[0])
    for w in ws[1:]:
        amax = torch.maximum(amax, column_amax(w))
    s = scale_of(amax)
    return [{Q_KEY: codes_of(w, s), S_KEY: s} for w in ws]


def _float_matrix(w) -> bool:
    return isinstance(w, torch.Tensor) and w.ndim >= 2 \
        and w.is_floating_point()


def quantize_params(params: Any) -> Any:
    """Leaf-by-leaf quantisation: every float leaf of two or more axes
    becomes ``{"__q", "__s"}`` with its own per-column scale."""
    return _map(lambda w: _quantize_shared([w])[0], params, _float_matrix)


def layer_stacks(cfg: ModelConfig) -> List[List[int]]:
    """The layer indices whose leaves the reference stacks into one array
    (one list per position of each scan group's cycle)."""
    out, base = [], 0
    for specs, count in cfg.scan_groups():
        for j in range(len(specs)):
            out.append([base + r * len(specs) + j for r in range(count)])
        base += len(specs) * count
    return out


def _quantize_stack(trees: List[Any]) -> List[Any]:
    """Same-shaped layer trees of one stack, every leaf quantised (stacked,
    even a vector is a matrix) with a scale shared over the stack."""
    if isinstance(trees[0], dict):
        per_key = {k: _quantize_stack([t[k] for t in trees])
                   for k in trees[0]}
        return [{k: v[r] for k, v in per_key.items()}
                for r in range(len(trees))]
    return _quantize_shared(trees)


def _quantize_layers(layers: List[Any], stacks: List[List[int]]
                     ) -> List[Any]:
    out: List[Any] = [None] * len(layers)
    for idx in stacks:
        for i, q in zip(idx, _quantize_stack([layers[i] for i in idx])):
            out[i] = q
    return out


def quantize_model(params: Any, cfg: ModelConfig) -> Any:
    """The model's parameters as the reference's ``quantize_params`` gives
    them on its stacked tree, one entry per layer: layer leaves share
    their scale over the reference's stacks (the encoder's layers form one
    stack), the other leaves are quantised on their own."""
    out = {k: quantize_params(v) for k, v in params.items()
           if k not in ("layers", "encoder")}
    out["layers"] = _quantize_layers(params["layers"], layer_stacks(cfg))
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {
            "final_norm": enc["final_norm"],
            "layers": _quantize_layers(enc["layers"],
                                       [list(range(len(enc["layers"])))])}
    return out


def quantize_model_decls(decls: Any) -> Any:
    """A model's declarations (``transformer.model_decls``) with the
    storage :func:`quantize_model` gives: every float leaf of a layer,
    and every other float leaf of two or more axes, as int8 codes."""
    out = {k: quantize_decls(v) for k, v in decls.items()
           if k not in ("layers", "encoder")}
    out["layers"] = _quantize_layer_decls(decls["layers"])
    if "encoder" in decls:
        out["encoder"] = {
            "final_norm": decls["encoder"]["final_norm"],
            "layers": _quantize_layer_decls(decls["encoder"]["layers"])}
    return out


def _quantize_layer_decls(layers: List[Any]) -> List[Any]:
    return _map(lambda d: _q_decl(d) if d.dtype in _FLOATS else d, layers,
                lambda x: isinstance(x, ParamDecl))
