"""The layer-program executor: one event-domain network step, per-step.

Counterpart of ``repro.core.layer_program`` for the per-step lowering.
:func:`compile_program` lowers an ``SNNSpec`` into a :class:`LayerProgram`
(a typed sequence of :class:`LayerOp`), and :func:`window_step` advances
every serving slot through one window of timesteps: per timestep, layer by
layer, ``leak -> scatter -> clip -> fire -> reset``, where each layer's
scatter is one slot-batched CUDA launch (`kernels/event_conv`,
`kernels/event_pool`, `kernels/event_fc`) and the FIRE frame is routed to
the next layer's events on the device (:func:`frame_to_events`).

Two dtype policies, as in the reference: ``"f32-carrier"`` (integers in
float32; also runs float nets) and ``"int8-native"`` (int8 codes and
resident slabs, int32 accumulation) — bitwise the same results on an
integer-domain net.  The fused lowerings (``"fused-window"``,
``"fused-network"``) are not ported yet and are refused at compile time.

The step runs eagerly (the reference jits it); it builds new state
tensors and never updates its inputs in place.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING, Optional, Sequence, Tuple

import torch

from repro_torch.core import events as ev
from repro_torch.core.econv import EConvParams, EConvSpec, _halo
from repro_torch.core.lif import (LifParams, apply_leak, fire_and_reset,
                                  idle_decay, supports_idle_skip)
from repro_torch.core.policies import (DTYPE_POLICIES, F32_CARRIER,
                                       FUSED_NETWORK, FUSED_WINDOW,
                                       INT8_NATIVE, PER_STEP,
                                       ExecutionPolicy)
from repro_torch.core.quant import INT8_MAX, INT8_MIN
from repro_torch.device import resolve_device
from repro_torch.kernels.event_conv.ops import event_conv_batched
from repro_torch.kernels.event_fc.ops import event_fc_batched
from repro_torch.kernels.event_pool.ops import event_pool_batched

if TYPE_CHECKING:  # pragma: no cover - annotation only
    from repro_torch.core.sne_net import SNNSpec

# the lowerings still to port, and the ROADMAP item that ports each
_NOT_PORTED = {
    FUSED_WINDOW: "ROADMAP Queue A item 4 (the fused-window lowering)",
    FUSED_NETWORK: "ROADMAP Queue A item 5 (the fused-network lowering)",
}


# ---------------------------------------------------------------------------
# Capacity heuristics — the reference's single source, copied.
# ---------------------------------------------------------------------------

# expected activity and headroom the buckets are sized for
STEP_ACTIVITY, STREAM_ACTIVITY, SLACK, STEP_ALIGN = 0.25, 0.05, 4.0, 8


def layer_step_capacity(lspec: EConvSpec) -> int:
    """Per-timestep *input*-event bucket for one layer (collector + FIFOs)."""
    return ev.capacity_for((1,) + lspec.in_shape, STEP_ACTIVITY, SLACK,
                           align=STEP_ALIGN)


def layer_stream_capacity(lspec: EConvSpec, n_timesteps: int) -> int:
    """Whole-inference *output*-event buffer for one layer (FIFO/DMA)."""
    return ev.capacity_for((n_timesteps,) + lspec.out_shape, STREAM_ACTIVITY,
                           SLACK)


# ---------------------------------------------------------------------------
# The program: SNNSpec -> typed ops.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerOp:
    """One layer lowered onto the homogeneous event datapath: scatter
    kind, halo width, per-timestep input capacity, LIF plan and dtype
    policy."""

    index: int
    spec: EConvSpec
    halo: int
    step_capacity: int
    dtype_policy: str = F32_CARRIER

    @property
    def kind(self) -> str:
        """Scatter kind ("conv" | "pool" | "fc")."""
        return self.spec.kind

    @property
    def lif(self) -> LifParams:
        """The layer's LIF plan (shared boundary dynamics)."""
        return self.spec.lif


@dataclasses.dataclass(frozen=True)
class LayerProgram:
    """A compiled eCNN: the op sequence :func:`window_step` executes, the
    policy axes compiled in, and the device it serves on."""

    spec: "SNNSpec"
    ops: Tuple[LayerOp, ...]
    dtype_policy: str = F32_CARRIER
    fusion_policy: str = PER_STEP
    device: str = "cuda"

    @property
    def step_capacities(self) -> Tuple[int, ...]:
        """Per-layer per-timestep event buckets the program baked in."""
        return tuple(op.step_capacity for op in self.ops)


def state_dtype(op: LayerOp) -> torch.dtype:
    """Membrane *storage* dtype between timesteps (the resident slabs)."""
    return torch.int8 if op.dtype_policy == INT8_NATIVE else torch.float32


def acc_dtype(op: LayerOp) -> torch.dtype:
    """Accumulator dtype a timestep computes in (leak/scatter/fire)."""
    return torch.int32 if op.dtype_policy == INT8_NATIVE else torch.float32


def scatter_dtypes(op: LayerOp):
    """Dtypes of one scatter launch: ``(v_in, v_out, weights, gate)``.

    The native path feeds the kernel its int8 slab when a "toward_zero"
    leak keeps the post-leak state in int8 range, else the int32-widened
    slab; gates ride at the slab dtype.
    """
    if op.dtype_policy == INT8_NATIVE:
        v_in = (torch.int8 if op.lif.leak_mode == "toward_zero"
                else torch.int32)
        return v_in, torch.int32, torch.int8, v_in
    f = torch.float32
    return f, f, f, f


def validate_policy_layer(lspec: EConvSpec, index: int,
                          dtype_policy: str) -> None:
    """Reject a layer the named datapath cannot execute exactly
    (int8-native needs integral threshold / leak and an int8 clip)."""
    if dtype_policy not in DTYPE_POLICIES:
        raise ValueError(f"unknown dtype policy {dtype_policy!r} "
                         f"(expected one of {DTYPE_POLICIES})")
    if dtype_policy == F32_CARRIER:
        return
    p = lspec.lif
    if p.state_clip is None or not (0 < p.state_clip <= INT8_MAX):
        raise ValueError(
            f"layer {index}: int8-native requires state_clip in (0, "
            f"{INT8_MAX}], got {p.state_clip} — lower the net with "
            f"core.quant.quantize_net first")
    for name, val in (("threshold", p.threshold), ("leak", p.leak),
                      ("state_clip", p.state_clip)):
        if not float(val).is_integer():
            raise ValueError(
                f"layer {index}: int8-native requires integral {name}, got "
                f"{val} — lower the net with core.quant.quantize_net")


def compile_program(spec: "SNNSpec",
                    step_capacities: Optional[Tuple[int, ...]] = None,
                    policy: Optional[ExecutionPolicy] = None,
                    device=None) -> LayerProgram:
    """Compile ``SNNSpec`` into the op sequence :func:`window_step` runs.

    ``policy`` defaults to the per-step lowering on the float32 carrier.
    A fused fusion policy raises ``NotImplementedError`` (not ported yet).
    ``device`` (default: CUDA) is where the program serves; asking for
    CUDA without a card raises.  Equal calls share one cached program.
    """
    pol = policy if policy is not None else ExecutionPolicy(
        fusion_policy=PER_STEP)
    if not isinstance(pol, ExecutionPolicy):
        raise TypeError(f"policy must be an ExecutionPolicy, got "
                        f"{type(pol).__name__}")
    if pol.fusion_policy in _NOT_PORTED:
        raise NotImplementedError(
            f"fusion policy {pol.fusion_policy!r} is not ported to the "
            f"PyTorch/CUDA package yet: {_NOT_PORTED[pol.fusion_policy]}; "
            f"use ExecutionPolicy(fusion_policy='per-step')")
    dev = resolve_device(device)
    caps = None if step_capacities is None else tuple(step_capacities)
    return _compile_cached(spec, caps, pol.dtype_policy, str(dev))


@functools.lru_cache(maxsize=64)
def _compile_cached(spec: "SNNSpec", step_capacities, dtype_policy: str,
                    device: str) -> LayerProgram:
    if step_capacities is not None and len(step_capacities) != len(
            spec.layers):
        raise ValueError("need one per-timestep capacity per layer")
    if dtype_policy not in DTYPE_POLICIES:
        raise ValueError(f"unknown dtype policy {dtype_policy!r} "
                         f"(expected one of {DTYPE_POLICIES})")
    ops = []
    for i, l in enumerate(spec.layers):
        validate_policy_layer(l, i, dtype_policy)
        cap = (step_capacities[i] if step_capacities is not None
               else layer_step_capacity(l))
        ops.append(LayerOp(index=i, spec=l, halo=_halo(l), step_capacity=cap,
                           dtype_policy=dtype_policy))
    return LayerProgram(spec=spec, ops=tuple(ops), dtype_policy=dtype_policy,
                        fusion_policy=PER_STEP, device=device)


# ---------------------------------------------------------------------------
# State geometry (slot-batched).
# ---------------------------------------------------------------------------

def padded_state(op: LayerOp, n_slots: int, device=None) -> torch.Tensor:
    """Zero halo-padded membrane slabs ``(n_slots, Hp, Wp, C)`` in the op's
    storage dtype (:func:`state_dtype`)."""
    Ho, Wo, Co = op.spec.out_shape
    h = op.halo
    return torch.zeros((n_slots, Ho + 2 * h, Wo + 2 * h, Co),
                       dtype=state_dtype(op), device=device)


def interior(vp: torch.Tensor, h: int) -> torch.Tensor:
    """Crop the halo off ``(..., Hp, Wp, C)`` (a view)."""
    if h == 0:
        return vp
    return vp[..., h:vp.shape[-3] - h, h:vp.shape[-2] - h, :]


def write_interior(vp: torch.Tensor, x: torch.Tensor, h: int) -> torch.Tensor:
    """A new buffer: ``vp`` with its logical interior replaced by ``x``."""
    if h == 0:
        return x
    out = vp.clone()
    out[..., h:vp.shape[-3] - h, h:vp.shape[-2] - h, :] = x
    return out


def clip_state(v: torch.Tensor, p: LifParams) -> torch.Tensor:
    """8-bit-state saturation (no-op when the layer has no clip)."""
    if p.state_clip is None:
        return v
    c = torch.as_tensor(p.state_clip, dtype=v.dtype, device=v.device)
    return torch.clamp(v, -c, c)


# ---------------------------------------------------------------------------
# The scatter: one slot-batched kernel launch per layer, any kind.
# ---------------------------------------------------------------------------

def check_native_weights(op: LayerOp, params: EConvParams) -> None:
    """int8-native requires integer weight codes, loudly."""
    if (op.dtype_policy == INT8_NATIVE
            and (params.w.is_floating_point() or params.w.is_complex())):
        raise ValueError(
            f"layer {op.index} ({op.kind}): int8-native execution needs "
            f"integer weight codes, got {params.w.dtype} — lower the net "
            f"with core.quant.quantize_net and use params_for('int8-native')")


def scatter_events_batched(op: LayerOp, params: EConvParams,
                           vp: torch.Tensor, xyc: torch.Tensor,
                           gate: torch.Tensor) -> torch.Tensor:
    """Accumulate all slots' event batches into all slots' membranes.

    One slot-batched launch per layer whatever the kind; operands ride at
    :func:`scatter_dtypes`, and conv events shift into halo coordinates
    here (not in the kernel).  Returns the slab in the accumulator dtype.
    """
    spec = op.spec
    check_native_weights(op, params)
    v_in, v_out, w_dt, g_dt = scatter_dtypes(op)
    vp = vp.to(v_in).contiguous()
    w = params.w.to(w_dt).contiguous()
    gate = gate.to(g_dt).contiguous()
    xyc = xyc.to(torch.int32)
    if spec.kind == "conv":
        off = torch.tensor([spec.padding, spec.padding, 0], dtype=torch.int32,
                           device=xyc.device)
        return event_conv_batched(vp, w, (xyc + off).contiguous(), gate,
                                  out_dtype=v_out)
    xyc = xyc.contiguous()
    if spec.kind == "pool":
        return event_pool_batched(vp, w, xyc, gate, stride=spec.stride,
                                  out_dtype=v_out)
    return event_fc_batched(vp, w, xyc, gate, in_shape=spec.in_shape,
                            out_dtype=v_out)


# ---------------------------------------------------------------------------
# The executor step: leak -> scatter -> clip -> fire -> reset, any kind.
# ---------------------------------------------------------------------------

def layer_timestep(op: LayerOp, params: EConvParams, vp: torch.Tensor,
                   xyc: torch.Tensor, gate: torch.Tensor,
                   alive_t: torch.Tensor):
    """One layer × one timestep for every slot: the uniform datapath.

    ``alive_t`` (N,) freezes slots with no timestep here: their state is
    held and their spikes zeroed.  On the native path the leak runs in
    int32, the scatter takes the narrowest exact slab, clip/fire/reset run
    in int32 and the slab saturates back to int8 storage.  Returns
    ``(vp_new, spikes)`` with spikes in the accumulator dtype.
    """
    lp = op.lif
    h = op.halo
    if op.dtype_policy == INT8_NATIVE:
        acc = acc_dtype(op)
        v_in_dt = scatter_dtypes(op)[0]
        v_l = apply_leak(interior(vp, h).to(acc), lp.leak, 1, lp.leak_mode)
        vp_l = write_interior(vp.to(v_in_dt), v_l.to(v_in_dt), h)
        vp_s = scatter_events_batched(op, params, vp_l, xyc, gate)  # int32
        v = clip_state(interior(vp_s, h), lp)
        v, s = fire_and_reset(v, lp)
        vp_new = write_interior(vp_s, v, h)
        vp_new = torch.clamp(vp_new, INT8_MIN, INT8_MAX).to(torch.int8)
    else:
        vp_l = write_interior(vp, apply_leak(interior(vp, h), lp.leak, 1,
                                             lp.leak_mode), h)
        vp_s = scatter_events_batched(op, params, vp_l, xyc, gate)
        v = clip_state(interior(vp_s, h), lp)
        v, s = fire_and_reset(v, lp)
        vp_new = write_interior(vp_s, v, h)
    m = alive_t.reshape(-1, 1, 1, 1) > 0
    s = torch.where(m, s, torch.zeros_like(s))
    return torch.where(m, vp_new, vp), s


def frame_to_events(s: torch.Tensor, cap: int):
    """Slot-batched dense spike frames -> padded event lists (routing).

    ``s`` (N, H, W, C) binary frames.  Returns ``(xyc (N, cap, 3) int32,
    gate (N, cap) in s.dtype, n_drop (N,) int32)``: the first ``cap``
    nonzero sites of each slot in row-major order, padding clamped to the
    last site with gate 0, and the overflow past ``cap`` counted.
    """
    N, H, W, C = s.shape
    S = H * W * C
    cap = min(cap, S)
    nz = s.reshape(N, S) != 0
    idx = torch.arange(S, device=s.device, dtype=torch.int64)
    key = torch.where(nz, idx, torch.full_like(idx, S))
    order = torch.topk(key, cap, dim=1, largest=False, sorted=True).values
    gate = (order < S).to(s.dtype)
    order = torch.clamp(order, max=S - 1)
    xyc = torch.stack([order // (W * C), (order // C) % W, order % C],
                      dim=-1).to(torch.int32)
    n = nz.sum(dim=1, dtype=torch.int32)
    n_drop = torch.clamp(n - cap, min=0)
    return xyc, gate, n_drop


def apply_idle_decay(states, dt: torch.Tensor, *, program: LayerProgram):
    """Apply each slot's deferred idle decay to every layer's interior.

    ``dt`` (N,) counts the input-free timesteps deferred while the slot was
    skipped; slots with ``dt == 0`` come back bit-identical.
    """
    dt4 = dt.reshape(-1, 1, 1, 1)
    out = []
    for vp, op in zip(states, program.ops):
        if not supports_idle_skip(op.lif):
            out.append(vp)     # soft reset: idle skip is off, dt is zero
            continue
        v_in = interior(vp, op.halo)
        if op.dtype_policy == INT8_NATIVE:
            # decay in the wide accumulator; the result is clipped, so the
            # downcast back to int8 is exact
            dec = idle_decay(v_in.to(acc_dtype(op)), op.lif,
                             dt4).to(torch.int8)
        else:
            dec = idle_decay(v_in, op.lif, dt4.to(v_in.dtype))
        out.append(write_interior(vp, dec, op.halo))
    return tuple(out)


def window_step(params: Sequence[EConvParams], states, class_counts,
                ev_xyc, ev_gate, alive, pre_dt, *, program: LayerProgram):
    """Advance every slot through one window of timesteps (per-step).

    Per timestep the program chain runs layer by layer, each layer one
    slot-batched scatter launch (L×T launches per window), with
    :func:`frame_to_events` routing each FIRE frame into the next layer's
    event bucket on the device.

    Args:
      states:       per-layer membrane slabs, each (N, Hp, Wp, C).
      class_counts: (N, n_classes) float32 running rate-decode counts.
      ev_xyc:       (W, N, E0, 3) int32 layer-0 events per timestep.
      ev_gate:      (W, N, E0) validity gates.
      alive:        (W, N) 1.0 where the slot has a real timestep.
      pre_dt:       (N,) deferred idle timesteps, decayed before stepping.

    Returns new states, class_counts, per-layer per-slot consumed-event
    counts (L, N) float32 and inter-layer overflow drops (L, N) int32.
    """
    if program.fusion_policy != PER_STEP:
        raise NotImplementedError(_NOT_PORTED.get(program.fusion_policy,
                                                  program.fusion_policy))
    if str(class_counts.device) != program.device:
        raise ValueError(f"the program serves on {program.device}, the "
                         f"state lives on {class_counts.device}")
    for op, p in zip(program.ops, params):
        check_native_weights(op, p)
    L = len(program.ops)
    N = class_counts.shape[0]
    dev = class_counts.device
    states = list(apply_idle_decay(states, pre_dt, program=program))
    counts = torch.zeros((L, N), dtype=torch.float32, device=dev)
    drops = torch.zeros((L, N), dtype=torch.int32, device=dev)
    for t in range(ev_xyc.shape[0]):
        xyc, gate, alive_t = ev_xyc[t], ev_gate[t], alive[t]
        s = None
        for op, p in zip(program.ops, params):
            if op.index > 0:
                xyc, gate, n_drop = frame_to_events(s, op.step_capacity)
                drops[op.index] += n_drop
            counts[op.index] += gate.sum(dim=1).to(torch.float32)
            states[op.index], s = layer_timestep(op, p, states[op.index],
                                                 xyc, gate, alive_t)
        # class counts stay float32 under every policy (exact integer sums)
        class_counts = class_counts + s.sum(dim=(1, 2)).to(torch.float32)
    return tuple(states), class_counts, counts, drops
