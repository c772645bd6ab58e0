"""Weights carried into the port as numpy arrays.

The JAX reference's PRNG cannot be matched, so trained or initialised
weights cross between the packages as numpy: :func:`params_from_numpy`
turns per-layer ``w`` arrays into the port's params on a device, and
:func:`load_net` reads the reference trainer's ``save_net`` ``.npz``
artifact (``format_version``, ``n_layers``, ``w0..wN``, ``meta_<key>``).
Every shape is validated against the spec's own layouts.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

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
