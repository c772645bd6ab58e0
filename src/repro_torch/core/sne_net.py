"""eCNN network assembly — the paper's Fig. 6 topology and friends.

Counterpart of ``repro.core.sne_net`` (specs and initialisation).  The
Fig. 6 network:

    128x128x2 -> sum-pool 4 -> conv 16c5(p2) -> pool 2 -> conv 32c3(p1)
              -> pool 2 -> FC 512 -> FC 11

Weights are drawn from a numpy ``Generator``: JAX's PRNG is not matched,
so whatever must agree across the two packages crosses as numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.econv import EConvParams, EConvSpec
from repro_torch.core.lif import LifParams
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SNNSpec:
    """A whole eCNN: the per-layer specs plus run geometry."""

    layers: Tuple[EConvSpec, ...]
    n_timesteps: int
    n_classes: int

    @property
    def in_shape(self):
        """Sensor-facing input geometry (layer 0's)."""
        return self.layers[0].in_shape


def _lif(th=1.0, leak=0.03125):
    return LifParams(threshold=th, leak=leak)


def dvs_gesture_net(n_timesteps: int = 100, height: int = 128,
                    width: int = 128, pol: int = 2,
                    n_classes: int = 11) -> SNNSpec:
    """The paper's accuracy-benchmark network (Fig. 6)."""
    l0 = EConvSpec("pool", (height, width, pol), pol, kernel=4, stride=4,
                   lif=_lif(th=0.999))  # sum-pool: any input spike passes
    s0 = l0.out_shape
    l1 = EConvSpec("conv", s0, 16, kernel=5, padding=2, lif=_lif(1.0))
    l2 = EConvSpec("pool", l1.out_shape, 16, kernel=2, stride=2,
                   lif=_lif(0.999))
    l3 = EConvSpec("conv", l2.out_shape, 32, kernel=3, padding=1,
                   lif=_lif(1.0))
    l4 = EConvSpec("pool", l3.out_shape, 32, kernel=2, stride=2,
                   lif=_lif(0.999))
    l5 = EConvSpec("fc", l4.out_shape, 512, lif=_lif(1.0))
    l6 = EConvSpec("fc", l5.out_shape, n_classes, lif=_lif(1.0))
    return SNNSpec(layers=(l0, l1, l2, l3, l4, l5, l6),
                   n_timesteps=n_timesteps, n_classes=n_classes)


def nmnist_net(n_timesteps: int = 60, n_classes: int = 10) -> SNNSpec:
    """NMNIST variant (34x34x2 input; same topology family)."""
    l1 = EConvSpec("conv", (34, 34, 2), 12, kernel=5, padding=1, lif=_lif())
    l2 = EConvSpec("pool", l1.out_shape, 12, kernel=2, stride=2,
                   lif=_lif(0.999))
    l3 = EConvSpec("conv", l2.out_shape, 32, kernel=3, padding=1, lif=_lif())
    l4 = EConvSpec("pool", l3.out_shape, 32, kernel=2, stride=2,
                   lif=_lif(0.999))
    l5 = EConvSpec("fc", l4.out_shape, n_classes, lif=_lif(1.0))
    return SNNSpec(layers=(l1, l2, l3, l4, l5), n_timesteps=n_timesteps,
                   n_classes=n_classes)


def tiny_net(n_timesteps: int = 16, n_classes: int = 4) -> SNNSpec:
    """Reduced config for CPU smoke tests."""
    l1 = EConvSpec("conv", (12, 12, 2), 6, kernel=3, padding=1, lif=_lif())
    l2 = EConvSpec("pool", l1.out_shape, 6, kernel=2, stride=2,
                   lif=_lif(0.999))
    l3 = EConvSpec("fc", l2.out_shape, n_classes, lif=_lif())
    return SNNSpec(layers=(l1, l2, l3), n_timesteps=n_timesteps,
                   n_classes=n_classes)


def init_econv_numpy(rng: np.random.Generator, spec: EConvSpec) -> np.ndarray:
    """One layer's float32 weights with the reference's ``init_econv``
    scales (He-style ×4 for conv/fc, unit synapses for pool)."""
    if spec.kind == "pool":
        return np.ones(spec.weight_shape, np.float32)
    scale = (2.0 / spec.fan_in) ** 0.5       # K·K·Ci for conv, Din for fc
    w = rng.standard_normal(spec.weight_shape).astype(np.float32)
    return (w * np.float32(scale) * np.float32(4.0)).astype(np.float32)


def init_snn(rng: np.random.Generator, spec: SNNSpec,
             device=None) -> List[EConvParams]:
    """Initialise every layer's synapses from one numpy ``Generator``.

    Returns float32 params on ``device`` (default: the CUDA device).
    """
    dev = resolve_device(device)
    return [EConvParams(w=torch.from_numpy(init_econv_numpy(rng, l)).to(dev))
            for l in spec.layers]
