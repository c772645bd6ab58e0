"""eCNN network assembly — the paper's Fig. 6 topology and friends.

Counterpart of ``repro.core.sne_net``: specs, initialisation, the
dense execution that training runs (:func:`dense_apply`, rate decoding
and the two losses; batch is a leading axis where the reference maps one
sample at a time) and the single-stream event execution
(:func:`event_apply`, :func:`event_predict`).  The Fig. 6 network:

    128x128x2 -> sum-pool 4 -> conv 16c5(p2) -> pool 2 -> conv 32c3(p1)
              -> pool 2 -> FC 512 -> FC 11

Weights are drawn from a numpy ``Generator``: JAX's PRNG is not matched,
so whatever must agree across the two packages crosses as numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core.econv import (EConvParams, EConvSpec, EConvStats,
                                    dense_forward)
from repro_torch.core.layer_program import (check_on_device,
                                            compile_program,
                                            default_stream_capacities,
                                            run_stream)
from repro_torch.core.lif import LifParams
from repro_torch.core.policies import F32_CARRIER, PER_STEP, ExecutionPolicy
from repro_torch.core.quant import QuantizedLayer, fake_quant_weights
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


# ---------------------------------------------------------------------------
# Dense execution (training path)
# ---------------------------------------------------------------------------

def dense_apply(params: Sequence[EConvParams], spec: SNNSpec,
                spikes: torch.Tensor, train: bool = False,
                qat: bool = False):
    """Forward ``(..., T, H, W, C)`` through all layers; returns
    ``(out_spikes, per-layer spikes)``.  ``qat`` fake-quantises conv/fc
    weights per output channel, as the reference's ``dense_apply`` does."""
    acts = []
    x = spikes
    for p, l in zip(params, spec.layers):
        if qat and l.kind != "pool":
            p = EConvParams(w=fake_quant_weights(p.w))
        x, _ = dense_forward(p, l, x, train=train)
        acts.append(x)
    return x, acts


def spike_counts(out_spikes: torch.Tensor) -> torch.Tensor:
    """Rate decoding: output spikes per class, summed over the time axis
    of ``(..., T, Ho, Wo, Co)`` -> ``(..., Ho·Wo·Co)``."""
    return out_spikes.sum(-4).flatten(-3)


def count_loss(out_spikes: torch.Tensor, label: torch.Tensor, spec: SNNSpec,
               true_rate: float = 0.5, false_rate: float = 0.02
               ) -> torch.Tensor:
    """SLAYER-style spike-count target loss, one value per sample."""
    counts = spike_counts(out_spikes)
    target = torch.full_like(counts, false_rate * spec.n_timesteps)
    target = target.scatter(-1, label.long()[..., None],
                            true_rate * spec.n_timesteps)
    return ((counts - target) ** 2).mean(-1)


def ce_loss(out_spikes: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over rate-decoded spike counts, one value per
    sample."""
    logp = torch.log_softmax(spike_counts(out_spikes), -1)
    return -logp.gather(-1, label.long()[..., None])[..., 0]


def predict(out_spikes: torch.Tensor) -> torch.Tensor:
    """Rate decoding: the class with the most output spikes (the first on
    a tie, as ``jnp.argmax``)."""
    return torch.argmax(spike_counts(out_spikes), -1)


# ---------------------------------------------------------------------------
# Event execution (the SNE model, layer by layer through the C-XBAR)
# ---------------------------------------------------------------------------

class NetworkEventStats(NamedTuple):
    """Whole-network event-path counters (per layer + totals)."""

    per_layer: Tuple[EConvStats, ...]
    total_events: torch.Tensor
    total_sops: torch.Tensor


def event_apply(params: Sequence[EConvParams], spec: SNNSpec,
                stream: ev.EventStream, capacities: Sequence[int],
                dtype_policy: str = F32_CARRIER, device=None):
    """Run the whole eCNN in the event domain, one stream.

    ``capacities[i]`` sizes layer *i*'s output event buffer.  The spec is
    compiled with the per-step fusion policy (`core.layer_program`,
    cached) and its stream executor (`layer_program.run_stream`) chains every
    layer; OP_RST and OP_FIRE events are honoured, which the serving
    engine refuses.  ``dtype_policy`` picks the datapath; the emitted
    stream is bitwise the same under both on an integer-domain net.
    ``device`` (default: CUDA) is where it runs: the stream and the
    weights must already lie there.  Returns the final output stream and
    :class:`NetworkEventStats`.
    """
    dev = resolve_device(device)
    check_on_device("event_apply", dev, stream, params)
    program = compile_program(spec, policy=ExecutionPolicy(
        dtype_policy=dtype_policy, fusion_policy=PER_STEP), device=dev)
    s, stats = run_stream(program, params, stream, capacities,
                          spec.n_timesteps)
    return s, NetworkEventStats(stats,
                                sum(st.n_update_events for st in stats),
                                sum(st.n_sops for st in stats))


def event_predict(params: Sequence[EConvParams], spec: SNNSpec,
                  stream: ev.EventStream, capacities: Sequence[int],
                  dtype_policy: str = F32_CARRIER, device=None):
    """Rate-decode one event-path inference: ``(class, counts, stats)``;
    counts are float32 output events per class, the class the first of
    the largest (``jnp.argmax``'s rule)."""
    out, stats = event_apply(params, spec, stream, capacities,
                             dtype_policy=dtype_policy, device=device)
    cls = torch.where(out.valid, out.c, spec.n_classes).long()
    counts = torch.zeros((spec.n_classes + 1,), dtype=torch.float32,
                         device=cls.device).index_add_(
        0, cls, torch.ones(cls.shape, dtype=torch.float32,
                           device=cls.device))[:-1]
    return torch.argmax(counts), counts, stats


def quantize_snn(params: Sequence[EConvParams],
                 spec: SNNSpec) -> Tuple[List[EConvParams], SNNSpec]:
    """Lower every layer to the SNE integer domain (4-bit weights, 8-bit
    state) layer by layer: float32-carrier codes and the integer spec.
    `core.quant.quantize_net` is the whole-network lowering that also
    gives the int8 codes of the int8-native policy."""
    qp, ql = [], []
    for p, l in zip(params, spec.layers):
        q = QuantizedLayer.from_float(l, p)
        qp.append(q.params)
        ql.append(q.spec)
    return qp, dataclasses.replace(spec, layers=tuple(ql))


def default_capacities(spec: SNNSpec, activity: float = 0.05,
                       slack: float = 4.0) -> List[int]:
    """Whole-inference output buffers for :func:`event_apply`, from the
    one sizing rule in `core.layer_program` (`layer_stream_capacity`)."""
    return default_stream_capacities(spec, activity, slack)
