"""Event-based convolution layer specs (paper §III-C, Listing 1).

Counterpart of ``repro.core.econv``: the static layer description, its
parameters, the halo rule and the dense (frame-based) path that training
differentiates through (:func:`dense_syn_current`, :func:`dense_forward`).
The event path (:func:`event_forward`) runs through `core.layer_program`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import TYPE_CHECKING, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.lif import LifParams, lif_rollout
from repro_torch.core.policies import F32_CARRIER
from repro_torch.device import resolve_device

if TYPE_CHECKING:  # pragma: no cover - annotation only
    from repro_torch.core import events as ev


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


# ---------------------------------------------------------------------------
# Event path — the SNE execution model (Listing 1), via the layer program.
# ---------------------------------------------------------------------------

class EConvStats(NamedTuple):
    """Per-layer event-path counters (the energy-model inputs), int32
    tensors on the stream's device."""

    n_update_events: torch.Tensor   # consumed UPDATE events
    n_sops: torch.Tensor            # nominal synaptic operations performed
    n_out_events: torch.Tensor      # emitted events (pre-overflow-drop)
    n_dropped: torch.Tensor         # output events lost to capacity overflow
    n_boundaries: torch.Tensor      # timestep boundaries processed


def event_forward(params: EConvParams, spec: EConvSpec,
                  stream: "ev.EventStream", out_capacity: int,
                  n_timesteps: int, dtype_policy: str = F32_CARRIER,
                  device=None):
    """Consume an event stream through one layer, produce its output stream.

    The one-layer entry point of the executor: the spec is lowered to a
    single `core.layer_program.LayerOp` and runs in
    `core.layer_program.layer_event_forward` — work proportional to the
    events and the *active* timestep boundaries (the lazy TLU leak skips
    idle ones).  ``dtype_policy`` picks the datapath ("f32-carrier", or
    "int8-native" for integer-domain specs and int8 codes).  ``device``
    (default: CUDA) is where it runs; the stream and the weights must
    already be there.  Returns ``(out_stream, membrane, EConvStats)``.
    """
    # local import: layer_program imports this module's spec/param types
    from repro_torch.core.layer_program import (check_on_device,
                                                layer_event_forward, layer_op)
    dev = resolve_device(device)
    check_on_device("event_forward", dev, stream, [params])
    return layer_event_forward(
        layer_op(spec, dtype_policy=dtype_policy, device=dev), params,
        stream, out_capacity, n_timesteps)


# ---------------------------------------------------------------------------
# Dense (frame-based) path — what training differentiates through.
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def dense_math():
    """Scope the dense path's numerics so that a step on the card computes
    the reference's float32 function and repeats bitwise: cuDNN off (its
    FFT and Winograd convolutions round differently from a direct sum, so
    an integer-domain or dyadic net's membranes would no longer be exact;
    PyTorch's own CUDA convolution is an im2col and a float32 GEMM), its
    TF32 off, deterministic algorithms, no autotuning.  The forward and
    the backward of a step both run inside it.  Matmuls must already be
    float32 (``torch.get_float32_matmul_precision() == "highest"``,
    PyTorch's default); anything else raises.  Nothing global changes
    outside the scope."""
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the dense path computes float32 matmuls; float32 matmul "
            f"precision is {torch.get_float32_matmul_precision()!r} — set "
            "it back to 'highest'")
    with torch.backends.cudnn.flags(enabled=False, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        yield


def dense_syn_current(params: EConvParams, spec: EConvSpec,
                      s: torch.Tensor) -> torch.Tensor:
    """Synaptic input of dense spike frames ``(..., H, W, C)`` ->
    ``(..., Ho, Wo, Co)``, every leading frame at once.

    Weights stay in the reference layouts; the permutes to ``conv2d``'s
    OIHW / NCHW happen here, under autograd.  The fc flattens each frame
    row-major over ``(H, W, C)`` (``Din = (x·W + y)·C + c``), the order
    the event fc kernels index.
    """
    H, W, C = spec.in_shape
    Ho, Wo, Co = spec.out_shape
    lead = s.shape[:-3]
    x = s.reshape((-1, H, W, C))
    if spec.kind == "conv":
        out = F.conv2d(x.permute(0, 3, 1, 2), params.w.permute(3, 2, 0, 1),
                       padding=spec.padding).permute(0, 2, 3, 1)
    elif spec.kind == "pool":
        k = spec.stride
        out = x[:, :Ho * k, :Wo * k].reshape((-1, Ho, k, Wo, k, C)).sum(
            (2, 4)) * params.w
    else:
        out = x.reshape((-1, H * W * C)) @ params.w
    return out.reshape(lead + (Ho, Wo, Co))


def dense_forward(params: EConvParams, spec: EConvSpec, spikes: torch.Tensor,
                  train: bool = False):
    """Run the dense path over ``(..., T, H, W, C)`` (leading batch axes
    optional); returns ``(spikes_out (..., T, Ho, Wo, Co), v_fin)``.

    A layer's synaptic input depends only on the previous layer's spikes,
    so it is computed for every frame in one call; only the LIF recurrence
    loops over time.
    """
    with dense_math():
        syn = dense_syn_current(params, spec, spikes)
        v0 = syn.new_zeros(syn.shape[:-4] + syn.shape[-3:])
        v_fin, out = lif_rollout(v0, syn, spec.lif, train,
                                 time_dim=syn.dim() - 4)
    return out, v_fin
