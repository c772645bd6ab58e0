"""Sharded stand-ins for every input of a dry-run cell (counterpart of
``repro.launch.specs``).

The reference builds ``jax.ShapeDtypeStruct``s carrying ``NamedSharding``s
resolved from the logical-axis declarations.  Here each leaf is a
:class:`Struct`: its declaration (shape, dtype, axes, initializer), the
:class:`PartitionSpec` that ``MeshRules.spec`` resolves from the axes on
the mesh, and the mesh itself (anything with a ``shape`` dict of axis
sizes).  Nothing is allocated until :func:`materialize` turns a tree into
tensors: storage-free ``meta`` tensors for the dry-run, or real ones on a
named device (the card checks of ``chip_smoke.py``).  The batch inputs
follow the reference's (shape x kind) table, frontend stubs included.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ShapeSpec
from repro_torch.distributed.sharding import MeshRules, PartitionSpec
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.frontend import frontend_feature_shape
from repro_torch.models.layers import ParamDecl, tree_leaves, tree_map
from repro_torch.models.quant_lm import quantize_model_decls
from repro_torch.models.transformer import cache_decls, model_decls
from repro_torch.optim.optimizers import AdamWState


@dataclasses.dataclass(frozen=True)
class Struct:
    """One leaf: its declaration, its spec on ``mesh``, and for integer
    inputs the exclusive upper bound of the values :func:`materialize`
    draws (``high``)."""

    decl: ParamDecl
    spec: PartitionSpec
    mesh: Any
    high: Optional[int] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.decl.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.decl.dtype

    def shards(self) -> int:
        """The number of pieces the spec cuts the leaf into."""
        n = 1
        for entry in self.spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                n *= self.mesh.shape[a]
        return n

    def nbytes(self) -> int:
        """The leaf's global bytes."""
        return math.prod(self.shape) * self.dtype.itemsize


def _struct(decl: ParamDecl, mesh, rules: MeshRules,
            high: Optional[int] = None) -> Struct:
    return Struct(decl, rules.spec(decl.axes, decl.shape, mesh), mesh, high)


def decl_specs(decls: Any, mesh, rules: MeshRules) -> Any:
    """A declaration tree's :class:`Struct` tree."""
    return tree_map(lambda d: _struct(d, mesh, rules), decls)


def param_specs(cfg: ModelConfig, mesh, rules: MeshRules,
                quantized: bool = False) -> Any:
    """The parameters' stand-ins (``quantized``: the int8 storage of
    ``quant_lm.quantize_model``, codes and scales)."""
    decls = model_decls(cfg)
    return decl_specs(quantize_model_decls(decls) if quantized else decls,
                      mesh, rules)


def opt_specs(cfg: ModelConfig, mesh, rules: MeshRules) -> AdamWState:
    """AdamW state: the step scalar and two moment trees shaped like the
    parameters, in ``cfg.moment_dtype``."""
    mdt = torch_dtype(cfg.moment_dtype)
    mom = tree_map(lambda s: dataclasses.replace(
        s, decl=dataclasses.replace(s.decl, dtype=mdt, init="zeros")),
        param_specs(cfg, mesh, rules))
    step = _struct(ParamDecl((), (), init="zeros", dtype=torch.int32),
                   mesh, rules)
    return AdamWState(step=step, mu=mom, nu=tree_map(lambda s: s, mom))


def cache_specs(cfg: ModelConfig, mesh, rules: MeshRules, B: int,
                S: int) -> Any:
    """The decode caches' stand-ins for ``B`` rows of ``S`` positions."""
    return decl_specs(cache_decls(cfg, B, S), mesh, rules)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                rules: MeshRules) -> Dict[str, Struct]:
    """The data batch of one (arch x shape) cell: ``tokens`` (and
    ``labels``) of (B, S) for train, (B, S) for prefill, (B, 1) and the
    (B,) positions ``pos`` for decode; the frontend stub's ``frames`` or
    ``patches`` for train and prefill.  Batch-sharded on dim 0."""
    B, S = shape.global_batch, shape.seq_len

    def leaf(shp, dtype=torch.int32, high=None, init="zeros"):
        axes = ("batch",) + (None,) * (len(shp) - 1)
        return _struct(ParamDecl(tuple(shp), axes, init=init, scale=1.0,
                                 dtype=dtype), mesh, rules, high)

    out: Dict[str, Struct] = {}
    if shape.kind == "train":
        out["tokens"] = leaf((B, S), high=cfg.vocab_size)
        out["labels"] = leaf((B, S), high=cfg.vocab_size)
    elif shape.kind == "prefill":
        out["tokens"] = leaf((B, S), high=cfg.vocab_size)
    else:  # decode: one new token against an S-length cache
        out["tokens"] = leaf((B, 1), high=cfg.vocab_size)
        out["pos"] = leaf((B,), high=S)
    if shape.kind in ("train", "prefill"):
        fs = frontend_feature_shape(cfg, B)
        if fs is not None:
            key = "frames" if cfg.frontend == "audio" else "patches"
            out[key] = leaf(fs, dtype=cfg.tdtype, init="normal")
    return out


def _leaves(tree) -> list:
    if isinstance(tree, AdamWState):
        return [tree.step] + _leaves(tree.mu) + _leaves(tree.nu)
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [leaf for _, leaf in tree_leaves(tree)]


def state_bytes_per_device(tree) -> float:
    """Bytes per device of a stand-in tree (or a tuple of trees): each
    leaf's bytes over the number of pieces its spec cuts it into (the
    reference's ``_analytic_state_bytes``)."""
    total = 0.0
    for s in _leaves(tree):
        total += s.nbytes() / s.shards()
    return total


def materialize(tree, device, gen: Optional[torch.Generator] = None):
    """Tensors for a stand-in tree on ``device``: on ``meta`` empty
    tensors (no storage); elsewhere the declaration's initializer drawn
    from ``gen`` (a generator on ``device``), integer inputs uniform in
    ``[0, high)``, the rest zeros."""
    dev = torch.device(device)

    def one(s: Struct) -> torch.Tensor:
        if dev.type == "meta":
            return torch.empty(s.shape, dtype=s.dtype, device=dev)
        if s.high is not None:
            return torch.randint(0, s.high, s.shape, generator=gen,
                                 device=dev, dtype=s.dtype)
        return s.decl.instantiate(gen, dev)

    if isinstance(tree, AdamWState):
        return AdamWState(one(tree.step), tree_map(one, tree.mu),
                          tree_map(one, tree.nu))
    return tree_map(one, tree)
