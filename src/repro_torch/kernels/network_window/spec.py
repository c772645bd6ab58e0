"""The static plan of one layer inside the fused-network megakernel.

Counterpart of ``repro.kernels.network_window.spec``.  The megakernel
chains every layer of a compiled program in one launch, so it needs each
layer's scatter kind, LIF plan, geometry and input capacity without
importing `core.layer_program` (the kernels never import the executor).
:class:`NetLayer` is that plan: a frozen value the executor lowers each
``LayerOp`` into.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.lif import LifParams


@dataclasses.dataclass(frozen=True)
class NetLayer:
    """One layer's static plan inside the fused-network megakernel.

    ``cap`` is the layer's per-timestep *input*-event capacity: for layer
    0 it names the collector bucket (the launch takes its width from the
    schedule); for every later layer it is the width of the event ring its
    producer routes into, already clamped to the producer's frame size.
    ``padding`` shifts a conv layer's input events into halo coordinates;
    ``stride`` and ``in_shape`` give the pool and fc scatter rules.
    """

    kind: str                            # "conv" | "pool" | "fc"
    lif: LifParams
    halo: int
    cap: int
    padding: int = 0                     # conv: input -> halo coordinates
    stride: int = 1                      # pool
    in_shape: Tuple[int, int, int] = (1, 1, 1)   # the input geometry
