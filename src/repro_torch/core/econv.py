"""Event-based convolution layer specs (paper §III-C, Listing 1).

Counterpart of the spec half of ``repro.core.econv``: the static layer
description, its parameters and the halo rule.  The event path itself runs
through `core.layer_program`; the dense (frame-based) path is not ported
in this slice.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.lif import LifParams


@dataclasses.dataclass(frozen=True)
class EConvSpec:
    """Static description of one eCNN layer."""

    kind: str                       # "conv" | "pool" | "fc"
    in_shape: Tuple[int, int, int]  # (H, W, C_in)
    out_channels: int
    kernel: int = 3
    stride: int = 1
    padding: int = 0
    lif: LifParams = LifParams()

    def __post_init__(self):
        if self.kind == "conv" and self.stride != 1:
            raise ValueError("event conv path supports stride=1 (use pool)")
        if self.kind == "pool" and self.kernel != self.stride:
            raise ValueError("pool layers require kernel == stride")

    @property
    def out_shape(self) -> Tuple[int, int, int]:
        """Output geometry (H, W, C) this layer's kind implies."""
        H, W, C = self.in_shape
        if self.kind == "conv":
            Ho = H + 2 * self.padding - self.kernel + 1
            Wo = W + 2 * self.padding - self.kernel + 1
            return (Ho, Wo, self.out_channels)
        if self.kind == "pool":
            return (H // self.stride, W // self.stride, C)
        if self.kind == "fc":
            return (1, 1, self.out_channels)
        raise ValueError(self.kind)

    @property
    def fan_in(self) -> int:
        """Synapses feeding one output neuron (init scaling)."""
        H, W, C = self.in_shape
        if self.kind == "conv":
            return self.kernel * self.kernel * C
        if self.kind == "pool":
            return self.stride * self.stride
        return H * W * C

    @property
    def weight_shape(self) -> Tuple[int, ...]:
        """Shape of this layer's ``w``: conv ``(K, K, Ci, Co)``, pool
        ``(C,)``, fc ``(Din, Dout)`` — the reference's layouts."""
        H, W, C = self.in_shape
        if self.kind == "conv":
            return (self.kernel, self.kernel, C, self.out_channels)
        if self.kind == "pool":
            return (C,)
        return (H * W * C, self.out_channels)

    def updates_per_event(self) -> int:
        """Neuron updates a single UPDATE event triggers (nominal)."""
        if self.kind == "conv":
            return self.kernel * self.kernel * self.out_channels
        if self.kind == "pool":
            return 1
        return self.out_channels


class EConvParams(NamedTuple):
    """One layer's synapses (shape depends on the kind, see
    :attr:`EConvSpec.weight_shape`)."""

    w: torch.Tensor


def _halo(spec: EConvSpec) -> int:
    """THE halo rule: conv scatters need K-1 address-filter headroom."""
    return spec.kernel - 1 if spec.kind == "conv" else 0
