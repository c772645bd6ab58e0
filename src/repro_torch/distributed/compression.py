"""Gradient compression: int8 all-reduce with error feedback, counterpart
of ``repro.distributed.compression``.

Data-parallel gradient all-reduce volume drops 4x (float32) by quantising
to int8 around the reduction; **error feedback** adds each step's
quantisation residual back before the next step's quantisation, so the
bias does not compound.

* :func:`int8_psum` — the all-reduce over a shard list: one scale shared
  through a ``pmax``, an exact int32 ``psum`` of the codes, dequantised.
* :class:`ErrorFeedback` / :func:`ef_compress` / :func:`ef_decompress` —
  the residual state and the per-leaf quantiser over the port's dict
  trees (`models.layers.tree_leaves` order).

Both packages round half to even (``jnp.round``, ``torch.round``) and
divide correctly rounded: the scale is always a tensor on the data's
device, since the card multiplies by the reciprocal of a Python-number
(or host-scalar) divisor.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.distributed.collectives import Axes, Parts, pmax, psum
from repro_torch.distributed.mesh import Mesh
from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten

INT8_MAX = 127.0


def _int8_scale(amax: torch.Tensor) -> torch.Tensor:
    return amax / torch.full_like(amax, INT8_MAX) + 1e-12


def quantize_int8(x: torch.Tensor, scale) -> torch.Tensor:
    """Round ``x / scale`` into the clipped int8 grid."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX).to(
        torch.int8)


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    """Map int8 codes back to float32: ``q * scale``."""
    return q.float() * scale


def int8_psum(parts: Parts, axes: Axes, mesh: Mesh) -> Parts:
    """``psum`` over ``axes`` with an int8 payload: every shard quantises
    into one grid (the ``pmax`` of the shards' largest magnitudes over
    127, plus 1e-12), the codes sum exactly in int32, and the sum is
    dequantised on each shard."""
    amax = [x.float().abs().max() for x in parts]
    scales = [_int8_scale(a) for a in pmax(amax, axes, mesh)]
    q = [quantize_int8(x.float(), s).to(torch.int32)
         for x, s in zip(parts, scales)]
    return [t.float() * s for t, s in zip(psum(q, axes, mesh), scales)]


class ErrorFeedback(NamedTuple):
    """Per-leaf residual state for error-feedback compression."""

    residual: Any      # a tree matching the grads


def ef_init(grads: Any) -> ErrorFeedback:
    """Zero float32 residuals shaped like ``grads``."""
    return ErrorFeedback(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads))


def _compress_leaf(g: torch.Tensor, r: torch.Tensor):
    corrected = g.float() + r
    scale = _int8_scale(corrected.abs().max())
    q = quantize_int8(corrected, scale)
    return q, scale, corrected - dequantize_int8(q, scale)


def ef_compress(grads: Any, ef: ErrorFeedback) -> Tuple[Any, Any,
                                                         ErrorFeedback]:
    """Quantise grads plus residual to int8, leaf by leaf.  Returns (codes,
    scales, new state): the caller reduces the codes across data-parallel
    ranks and dequantises with the scales; the residual carries what int8
    lost."""
    g_leaves, r_leaves = list(tree_leaves(grads)), list(
        tree_leaves(ef.residual))
    if [p for p, _ in g_leaves] != [p for p, _ in r_leaves]:
        raise ValueError("the residual tree does not match the grads")
    out = [_compress_leaf(g, r) for (_, g), (_, r) in zip(g_leaves,
                                                          r_leaves)]
    q8, scales, resid = ([tree_unflatten(grads, [o[i] for o in out])
                          for i in range(3)])
    return q8, scales, ErrorFeedback(residual=resid)


def ef_decompress(q8: Any, scales: Any) -> Any:
    """Dequantise a compressed tree leaf by leaf."""
    s_leaves = iter([s for _, s in tree_leaves(scales)])
    return tree_unflatten(q8, [dequantize_int8(q, next(s_leaves))
                               for _, q in tree_leaves(q8)])


def compression_ratio(grads: Any) -> float:
    """Collective payload ratio float32 -> int8, with one float32 scale a
    leaf."""
    leaves = [g for _, g in tree_leaves(grads)]
    n = sum(g.numel() for g in leaves)
    return (4.0 * n) / (1.0 * n + 4.0 * len(leaves))
