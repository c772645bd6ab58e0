"""Weights carried between the packages as numpy arrays.

The JAX reference's PRNG cannot be matched, so trained or initialised
weights cross between the packages as numpy, in both directions:
:func:`params_from_numpy` / :func:`params_to_numpy` convert per-layer
``w`` arrays, and :func:`save_net` / :func:`load_net` write and read the
single-file ``.npz`` artifact both trainers use (``format_version``,
``n_layers``, ``w0..wN`` float32, ``meta_<key>``), so a net trained by
either package is served by the other.  Every shape is validated against
the spec's own layouts.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.econv import EConvParams
from repro_torch.core.sne_net import SNNSpec
from repro_torch.device import resolve_device

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
