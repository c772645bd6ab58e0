"""Weights carried between the packages as numpy arrays.

The JAX reference's PRNG cannot be matched, so trained or initialised
weights cross between the packages as numpy, in both directions:
:func:`params_from_numpy` / :func:`params_to_numpy` convert per-layer
``w`` arrays, and :func:`save_net` / :func:`load_net` write and read the
single-file ``.npz`` artifact both trainers use (``format_version``,
``n_layers``, ``w0..wN`` float32, ``meta_<key>``), so a net trained by
either package is served by the other.  Every shape is validated against
the spec's own layouts.

For the LM substrate, :func:`lm_params_from_numpy` and
:func:`lm_cache_from_numpy` take the reference's parameter and decode
cache trees as numpy (nested dicts whose per-layer leaves are stacked by
scan group, ``groups/g{i}/l{j}``, and the encoder's by ``encoder/groups/
g0/l0``) and unstack them into the port's one-entry-per-layer trees, each
leaf checked against the port's own declarations
(:func:`lm_train_state_from_numpy` does the same for a training state, its
AdamW moments included).  A tree the reference's
``quantize_params`` made crosses too: each stacked ``__q`` is split along
its layer axis, and every layer of the stack gets the shared ``__s``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.econv import EConvParams
from repro_torch.core.sne_net import SNNSpec
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.quant_lm import (Q_KEY, S_KEY, is_qleaf,
                                         quantize_model_decls)
from repro_torch.optim.optimizers import AdamWState

NET_FORMAT_VERSION = 1


def params_from_numpy(arrays: Sequence[np.ndarray], spec: SNNSpec,
                      device=None) -> List[EConvParams]:
    """Per-layer numpy weights -> float32 params on ``device`` (default:
    the CUDA device), each shape checked against the spec."""
    dev = resolve_device(device)
    arrays = list(arrays)
    if len(arrays) != len(spec.layers):
        raise ValueError(f"{len(arrays)} weight arrays for "
                         f"{len(spec.layers)} layers")
    out = []
    for i, (a, l) in enumerate(zip(arrays, spec.layers)):
        a = np.asarray(a)
        if tuple(a.shape) != l.weight_shape:
            raise ValueError(f"w{i} shape {a.shape} != spec shape "
                             f"{l.weight_shape}")
        out.append(EConvParams(w=torch.from_numpy(
            np.ascontiguousarray(a, np.float32)).to(dev)))
    return out


def params_to_numpy(params: Sequence[EConvParams]) -> List[np.ndarray]:
    """Per-layer float32 numpy copies of the port's params."""
    return [p.w.detach().cpu().numpy().astype(np.float32) for p in params]


def save_net(path: str, params: Sequence[EConvParams],
             meta: Optional[dict] = None) -> None:
    """Write a net as one compressed ``.npz`` in the reference's
    ``save_net`` layout, which the reference's ``load_net`` reads."""
    arrs = {f"w{i}": a for i, a in enumerate(params_to_numpy(params))}
    extras = {f"meta_{k}": np.asarray(v) for k, v in (meta or {}).items()}
    np.savez_compressed(path, format_version=NET_FORMAT_VERSION,
                        n_layers=len(arrs), **arrs, **extras)


def load_net(path: str, spec: SNNSpec, device=None
             ) -> Tuple[List[EConvParams], dict]:
    """Load a ``save_net`` artifact validated against ``spec``.

    Returns ``(params, meta)`` with params on ``device`` (default: CUDA).
    """
    with np.load(path) as z:
        if int(z["format_version"]) != NET_FORMAT_VERSION:
            raise ValueError(f"{path}: unsupported net format version "
                             f"{int(z['format_version'])}")
        if int(z["n_layers"]) != len(spec.layers):
            raise ValueError(f"{path}: {int(z['n_layers'])} layers, spec "
                             f"has {len(spec.layers)}")
        arrays = [z[f"w{i}"] for i in range(len(spec.layers))]
        meta = {k[len("meta_"):]: z[k][()] for k in z.files
                if k.startswith("meta_")}
    return params_from_numpy(arrays, spec, device), meta


# ---------------------------------------------------------------------------
# LM parameter and cache trees
# ---------------------------------------------------------------------------


def _unstack_groups(groups: Dict[str, Any], cfg: ModelConfig) -> List[Any]:
    """The reference's scan-group stacks (``g{i}/l{j}``, each leaf with a
    leading repeat axis) as one subtree per layer, in layer order."""
    layers = []
    for i, (specs, count) in enumerate(cfg.scan_groups()):
        g = groups[f"g{i}"]
        for r in range(count):
            for j in range(len(specs)):
                layers.append(_layer_of(g[f"l{j}"], r))
    return layers


def _layer_of(tree, r: int):
    """Layer ``r`` of a stacked subtree; a quantised leaf keeps its scale,
    which the stack shares."""
    if is_qleaf(tree):
        return {Q_KEY: np.asarray(tree[Q_KEY])[r], S_KEY: tree[S_KEY]}
    if isinstance(tree, dict):
        return {k: _layer_of(v, r) for k, v in tree.items()}
    return np.asarray(tree)[r]


def _from_decls(tree: Any, decls: Any, dev: torch.device,
                path: Tuple = ()) -> Any:
    """``tree`` (numpy leaves) as tensors on ``dev`` in the dtypes of
    ``decls``, its keys and every shape checked against them."""
    where = "/".join(map(str, path)) or "tree"
    if isinstance(decls, dict):
        if not isinstance(tree, dict) or set(tree) != set(decls):
            got = set(tree) if isinstance(tree, dict) else set()
            raise ValueError(f"{where}: missing {sorted(set(decls) - got)}, "
                             f"unexpected {sorted(got - set(decls))}")
        return {k: _from_decls(tree[k], d, dev, path + (k,))
                for k, d in decls.items()}
    if isinstance(decls, list):
        if len(tree) != len(decls):
            raise ValueError(f"{where}: {len(tree)} entries, declared "
                             f"{len(decls)}")
        return [_from_decls(t, d, dev, path + (i,))
                for i, (t, d) in enumerate(zip(tree, decls))]
    a = np.asarray(tree)
    if tuple(a.shape) != tuple(decls.shape):
        raise ValueError(f"{where}: shape {tuple(a.shape)} != declared "
                         f"{decls.shape}")
    # bfloat16 arrays (ml_dtypes) go through float32, exactly
    return torch.from_numpy(np.array(a, np.float32)).to(device=dev,
                                                        dtype=decls.dtype)


def _per_layer(tree: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """A reference model tree (params, or moments of their shape) with its
    scan groups unstacked into ``layers`` (and the encoder's into
    ``encoder/layers``)."""
    flat = {k: v for k, v in tree.items() if k not in ("groups", "encoder")}
    flat["layers"] = _unstack_groups(tree["groups"], cfg)
    if "encoder" in tree:
        g = tree["encoder"]["groups"]["g0"]["l0"]
        n = cfg.encoder.n_layers if cfg.encoder is not None else 0
        flat["encoder"] = {"final_norm": tree["encoder"]["final_norm"],
                           "layers": [_layer_of(g, r) for r in range(n)]}
    return flat


def lm_params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                         device=None) -> Dict[str, Any]:
    """The reference's LM parameter tree (numpy leaves) as the port's
    parameters on ``device`` (default: the CUDA device), in
    ``cfg.tdtype``; a quantised tree (the reference's ``quantize_params``)
    as the port's ``quant_lm.quantize_model`` storage."""
    dev = resolve_device(device)
    flat = _per_layer(tree, cfg)
    decls = T.model_decls(cfg)
    if is_qleaf(tree.get("embed")):
        decls = quantize_model_decls(decls)
    return _from_decls(flat, decls, dev)


def lm_train_state_from_numpy(params: Dict[str, Any], opt_state: Any,
                              cfg: ModelConfig, device=None
                              ) -> Tuple[Dict[str, Any], AdamWState]:
    """The reference's ``init_train_state`` output (or a later training
    state) as the port's: ``params`` (numpy leaves, scan groups stacked)
    through :func:`lm_params_from_numpy`, and ``opt_state`` (the
    reference's ``AdamWState(step, mu, nu)``, its moments trees of the
    params' shape) as an ``AdamWState`` whose moments are unstacked the
    same way, in ``cfg.moment_dtype``, on ``device`` (default: the CUDA
    device)."""
    dev = resolve_device(device)
    moment_dtype = torch_dtype(cfg.moment_dtype)
    decls = tree_map(lambda d: dataclasses.replace(d, dtype=moment_dtype),
                     T.model_decls(cfg))

    def moments(tree):
        return _from_decls(_per_layer(tree, cfg), decls, dev)

    step = torch.tensor(int(np.asarray(opt_state.step)), dtype=torch.int32,
                        device=dev)
    return (lm_params_from_numpy(params, cfg, dev),
            AdamWState(step, moments(opt_state.mu), moments(opt_state.nu)))


def lm_cache_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                        cache_len: int, device=None) -> T.Cache:
    """The reference's decode cache (``groups/g{i}/l{j}``, numpy leaves)
    for ``cache_len`` positions as the port's per-layer cache on
    ``device`` (default: the CUDA device)."""
    dev = resolve_device(device)
    layers = _unstack_groups(tree, cfg)
    B = next(a for _, a in tree_leaves(layers)).shape[0]
    return _from_decls(layers, T.cache_decls(cfg, B, cache_len), dev)
