"""The layer-program executor: one event-domain network step.

Counterpart of ``repro.core.layer_program``.  :func:`compile_program`
lowers an ``SNNSpec`` into a :class:`LayerProgram` (a typed sequence of
:class:`LayerOp`), and :func:`window_step` advances every serving slot
through one window of timesteps.  The program's fusion policy picks the
lowering:

* ``"per-step"`` — per timestep, layer by layer, ``leak -> scatter ->
  clip -> fire -> reset``, each layer's scatter one slot-batched CUDA
  launch (`kernels/event_conv`, `kernels/event_pool`, `kernels/event_fc`;
  L×T launches per window).  The bitwise oracle of every other lowering.
* ``"fused-window"`` (the policy default) — layer by layer, each layer's
  whole window in ONE fused launch (the ``*_window`` kernels, tile
  sparsity included; L launches per window), with every timestep's FIRE
  frames routed at once.  Bitwise the per-step results.
* ``"fused-network"`` — the whole program over the whole window in ONE
  launch (`kernels/network_window`): a slot's layers spread over a
  thread-block cluster, each CTA holding its band of every membrane in
  shared memory, spikes routed between layers inside the kernel.
  Bitwise the per-step results; a program whose CTA share does not fit
  :data:`SMEM_BUDGET` warns and runs fused-window (:func:`effective_fusion`).

Two dtype policies, as in the reference: ``"f32-carrier"`` (integers in
float32; also runs float nets) and ``"int8-native"`` (int8 codes and
resident slabs, int32 accumulation) — bitwise the same results on an
integer-domain net.

The step runs eagerly (the reference jits it); it builds new state
tensors and never updates its inputs in place.  :func:`dense_program_forward`
is the dense, differentiable twin of the same op chain that training runs.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import (TYPE_CHECKING, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core.econv import (EConvParams, EConvSpec, EConvStats,
                                    _halo, dense_forward)
from repro_torch.core.lif import (LifParams, apply_leak, fire_and_reset,
                                  idle_decay, supports_idle_skip)
from repro_torch.core.policies import (DTYPE_POLICIES, F32_CARRIER,
                                       FUSED_NETWORK, FUSED_WINDOW,
                                       FUSION_POLICIES, INT8_NATIVE,
                                       PER_STEP, ExecutionPolicy)
from repro_torch.core.quant import INT8_MAX, INT8_MIN, fake_quant_weights
from repro_torch.device import resolve_device
from repro_torch.kernels.event_conv.ops import (conv_plan, conv_smem,
                                                event_conv,
                                                event_conv_batched,
                                                event_conv_window)
from repro_torch.kernels.event_fc.ops import (FC_SMEM, event_fc,
                                              event_fc_batched,
                                              event_fc_window)
from repro_torch.kernels.event_pool.ops import (event_pool,
                                                event_pool_batched,
                                                event_pool_window, pool_smem)
from repro_torch.kernels.network_window import (CLUSTER, SMEM_BUDGET,
                                                NetLayer, network_window,
                                                smem_layout)
from repro_torch.kernels.window_common import (crop_interior, dilate_conv,
                                               dilate_pool, route_frame,
                                               seed_site_map, sites_to_tiles,
                                               tile_grid, tiles_to_sites,
                                               write_cropped)

if TYPE_CHECKING:  # pragma: no cover - annotation only
    from repro_torch.core.sne_net import SNNSpec

# ---------------------------------------------------------------------------
# Capacity heuristics — the reference's single source, copied.
# ---------------------------------------------------------------------------

# expected activity and headroom the buckets are sized for
STEP_ACTIVITY, STREAM_ACTIVITY, SLACK, STEP_ALIGN = 0.25, 0.05, 4.0, 8


def layer_step_capacity(lspec: EConvSpec, activity: float = STEP_ACTIVITY,
                        slack: float = SLACK, align: int = STEP_ALIGN) -> int:
    """Per-timestep *input*-event bucket for one layer (collector + FIFOs):
    ``activity`` is the expected share of active input sites a step,
    ``slack`` the over-provisioning."""
    return ev.capacity_for((1,) + lspec.in_shape, activity, slack,
                           align=align)


def layer_stream_capacity(lspec: EConvSpec, n_timesteps: int,
                          activity: float = STREAM_ACTIVITY,
                          slack: float = SLACK) -> int:
    """Whole-inference *output*-event buffer for one layer (FIFO/DMA): the
    stream it may emit over ``n_timesteps`` on its output geometry."""
    return ev.capacity_for((n_timesteps,) + lspec.out_shape, activity,
                           slack)


def default_stream_capacities(spec: "SNNSpec",
                              activity: float = STREAM_ACTIVITY,
                              slack: float = SLACK) -> List[int]:
    """Whole-inference output buffers, one per layer (`event_apply`)."""
    return [layer_stream_capacity(l, spec.n_timesteps, activity, slack)
            for l in spec.layers]


def default_step_capacities(spec: "SNNSpec", activity: float = STEP_ACTIVITY,
                            slack: float = SLACK,
                            align: int = STEP_ALIGN) -> List[int]:
    """Per-timestep input buckets, one per layer (the serving collector)."""
    return [layer_step_capacity(l, activity, slack, align)
            for l in spec.layers]


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
    # conv: (padding, padding, 0), the shift of events into halo
    # coordinates, on the program's device; built once at compile time
    # (a ``torch.tensor`` per call is a blocking host-to-device copy)
    event_offset: Optional[torch.Tensor] = dataclasses.field(
        default=None, compare=False, repr=False)

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
    tile_sparsity: bool = True
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


def validate_policy_spec(spec: "SNNSpec", dtype_policy: str) -> None:
    """Whole-network face of :func:`validate_policy_layer`."""
    if dtype_policy not in DTYPE_POLICIES:
        raise ValueError(f"unknown dtype policy {dtype_policy!r} "
                         f"(expected one of {DTYPE_POLICIES})")
    for i, lspec in enumerate(spec.layers):
        validate_policy_layer(lspec, i, dtype_policy)


def layer_op(lspec: EConvSpec, index: int = 0,
             step_capacity: Optional[int] = None,
             dtype_policy: str = F32_CARRIER, device="cpu") -> LayerOp:
    """Lower one layer spec onto the datapath (validated against the
    dtype policy); a conv op carries its halo shift on ``device``."""
    validate_policy_layer(lspec, index, dtype_policy)
    off = (torch.tensor([lspec.padding, lspec.padding, 0], dtype=torch.int32,
                        device=device) if lspec.kind == "conv" else None)
    return LayerOp(index=index, spec=lspec, halo=_halo(lspec),
                   step_capacity=(layer_step_capacity(lspec)
                                  if step_capacity is None
                                  else step_capacity),
                   dtype_policy=dtype_policy, event_offset=off)


def compile_program(spec: "SNNSpec",
                    step_capacities: Optional[Tuple[int, ...]] = None,
                    policy: Optional[ExecutionPolicy] = None,
                    device=None) -> LayerProgram:
    """Compile ``SNNSpec`` into the op sequence :func:`window_step` runs.

    ``policy`` defaults to the per-step lowering on the float32 carrier
    (the reference's default here); its dtype policy, fusion policy and
    tile sparsity are compiled in.  ``device`` (default: CUDA)
    is where the program serves; asking for CUDA without a card raises.
    Equal calls share one cached program.
    """
    pol = policy if policy is not None else ExecutionPolicy(
        fusion_policy=PER_STEP)
    if not isinstance(pol, ExecutionPolicy):
        raise TypeError(f"policy must be an ExecutionPolicy, got "
                        f"{type(pol).__name__}")
    dev = resolve_device(device)
    caps = None if step_capacities is None else tuple(step_capacities)
    return _compile_cached(spec, caps, pol.dtype_policy, pol.fusion_policy,
                           pol.tile_sparsity, str(dev))


@functools.lru_cache(maxsize=64)
def _compile_cached(spec: "SNNSpec", step_capacities, dtype_policy: str,
                    fusion_policy: str, tile_sparsity: bool,
                    device: str) -> LayerProgram:
    if step_capacities is not None and len(step_capacities) != len(
            spec.layers):
        raise ValueError("need one per-timestep capacity per layer")
    if dtype_policy not in DTYPE_POLICIES:
        raise ValueError(f"unknown dtype policy {dtype_policy!r} "
                         f"(expected one of {DTYPE_POLICIES})")
    if fusion_policy not in FUSION_POLICIES:
        raise ValueError(f"unknown fusion policy {fusion_policy!r} "
                         f"(expected one of {FUSION_POLICIES})")
    ops = tuple(layer_op(l, i, None if step_capacities is None
                         else step_capacities[i], dtype_policy, device)
                for i, l in enumerate(spec.layers))
    return LayerProgram(spec=spec, ops=ops, dtype_policy=dtype_policy,
                        fusion_policy=fusion_policy,
                        tile_sparsity=tile_sparsity, device=device)


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


def clip_state(v: torch.Tensor, p: LifParams) -> torch.Tensor:
    """8-bit-state saturation (no-op when the layer has no clip)."""
    if p.state_clip is None:
        return v
    c = torch.full((), p.state_clip, dtype=v.dtype, device=v.device)
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
        return event_conv_batched(vp, w, (xyc + op.event_offset).contiguous(),
                                  gate, out_dtype=v_out)
    xyc = xyc.contiguous()
    if spec.kind == "pool":
        return event_pool_batched(vp, w, xyc, gate, stride=spec.stride,
                                  out_dtype=v_out)
    return event_fc_batched(vp, w, xyc, gate, in_shape=spec.in_shape,
                            out_dtype=v_out)


def scatter_launch_bytes(op: LayerOp, n_slots: int, n_events: int) -> int:
    """Bytes one slot-batched scatter launch moves: the int32 event
    triples and the gates of ``n_slots`` x ``n_events`` events, the shared
    weights, the membrane slab in and the accumulator slab out, each at
    the dtype :func:`scatter_dtypes` gives the launch (the reference's
    count, to the byte)."""
    v_in, v_out, w_dt, g_dt = scatter_dtypes(op)
    spec = op.spec
    Hp, Wp, Co = _slab_shape(op)
    slab = n_slots * Hp * Wp * Co
    if spec.kind == "conv":
        w_elems = spec.kernel ** 2 * spec.in_shape[2] * spec.out_channels
    elif spec.kind == "pool":
        w_elems = spec.in_shape[2]
    else:
        H, W, Ci = spec.in_shape
        w_elems = H * W * Ci * spec.out_channels
    return (n_slots * n_events * (3 * 4 + g_dt.itemsize)
            + w_elems * w_dt.itemsize
            + slab * (v_in.itemsize + v_out.itemsize))


def scatter_event(op: LayerOp, params: EConvParams, vp: torch.Tensor,
                  e_x: int, e_y: int, e_c: int, gate) -> torch.Tensor:
    """Accumulate ONE event's synaptic contribution into the single-stream
    slab ``vp`` (Hp, Wp, C) in place, and return it: the per-event rule
    the plain scan (:func:`_layer_event_forward_plain`) applies and the
    kernels apply to whole batches.  ``gate`` (a 0-dim tensor of the slab
    dtype) multiplies the weights, so a gated-off event adds ``w·0``.

    Conv: ``vp[ox:ox+K, oy:oy+K] += flip(W)[:, :, c, :]·gate`` at the
    origin in halo coordinates, clamped into the slab (as
    ``lax.dynamic_slice`` clamps); pool: ``vp[x//s, y//s, c] +=
    w[c]·gate``, dropped past the grid; fc: ``vp[0, 0] += W[(x·W+y)·C+c]
    ·gate``, dropped past ``Din``.  Out-of-range channels clamp, as the
    kernels' plain versions do.
    """
    spec = op.spec
    w = params.w
    if spec.kind == "conv":
        K = spec.kernel
        c = min(max(e_c, 0), w.shape[2] - 1)
        patch = torch.flip(w, (0, 1))[:, :, c, :] * gate        # (K, K, Co)
        ox = min(max(e_x + spec.padding, 0), vp.shape[0] - K)
        oy = min(max(e_y + spec.padding, 0), vp.shape[1] - K)
        vp[ox:ox + K, oy:oy + K] = vp[ox:ox + K, oy:oy + K] + patch
        return vp
    if spec.kind == "pool":
        s = spec.stride
        Ho, Wo, C = vp.shape
        if 0 <= e_x and 0 <= e_y and e_x // s < Ho and e_y // s < Wo \
                and 0 <= e_c < C:
            vp[e_x // s, e_y // s, e_c] = (vp[e_x // s, e_y // s, e_c]
                                           + w[e_c] * gate)
        return vp
    H, W, C = spec.in_shape
    flat = (e_x * W + e_y) * C + e_c
    if 0 <= flat < w.shape[0]:
        vp[0, 0, :] = vp[0, 0, :] + w[flat] * gate
    return vp


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
        v_l = apply_leak(crop_interior(vp, h).to(acc), lp.leak, 1,
                         lp.leak_mode)
        vp_l = write_cropped(vp.to(v_in_dt), v_l.to(v_in_dt), h)
        vp_s = scatter_events_batched(op, params, vp_l, xyc, gate)  # int32
        v = clip_state(crop_interior(vp_s, h), lp)
        v, s = fire_and_reset(v, lp)
        vp_new = write_cropped(vp_s, v, h)
        vp_new = torch.clamp(vp_new, INT8_MIN, INT8_MAX).to(torch.int8)
    else:
        vp_l = write_cropped(vp, apply_leak(crop_interior(vp, h), lp.leak,
                                            1, lp.leak_mode), h)
        vp_s = scatter_events_batched(op, params, vp_l, xyc, gate)
        v = clip_state(crop_interior(vp_s, h), lp)
        v, s = fire_and_reset(v, lp)
        vp_new = write_cropped(vp_s, v, h)
    m = alive_t.reshape(-1, 1, 1, 1) > 0
    s = torch.where(m, s, torch.zeros_like(s))
    return torch.where(m, vp_new, vp), s


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
        v_in = crop_interior(vp, op.halo)
        if op.dtype_policy == INT8_NATIVE:
            # decay in the wide accumulator; the result is clipped, so the
            # downcast back to int8 is exact
            dec = idle_decay(v_in.to(acc_dtype(op)), op.lif,
                             dt4).to(torch.int8)
        else:
            dec = idle_decay(v_in, op.lif, dt4.to(v_in.dtype))
        out.append(write_cropped(vp, dec, op.halo))
    return tuple(out)


def effective_tile_sparsity(program: LayerProgram) -> bool:
    """Whether the fused lowering threads tile activity bitmaps: the policy
    asks for them and every layer is hard-reset (a cold tile settles with
    one `core.lif.idle_decay`, which soft reset has no closed form for;
    such programs run dense).  The per-step lowering never consults this."""
    return (program.tile_sparsity
            and all(supports_idle_skip(op.lif) for op in program.ops))


def window_tile_maps(program: LayerProgram, ev_xyc: torch.Tensor,
                     ev_gate: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Per-layer (N, nTx, nTy) int32 tile activity bitmaps for one window.

    Seeds a layer-0 site map from the collector's events (``ev_xyc``
    (T, N, E0, 3), ``ev_gate`` (T, N, E0), layer coordinates), then walks
    the program: each layer dilates the incoming map through its
    receptive field (conv: K×K; pool: its stride window; fc: always hot)
    and coarsens it to its tile grid.  The next layer sees the upsampled
    *tile* footprint, not the raw site map: every site of a hot tile runs
    the fire sweep and may spike, so a finer map would undercount.
    """
    in_map = seed_site_map(ev_xyc, ev_gate, program.ops[0].spec.in_shape[:2])
    tiles = []
    for op in program.ops:
        spec = op.spec
        Ho, Wo, _ = spec.out_shape
        if spec.kind == "conv":
            out_map = dilate_conv(in_map, spec.kernel, spec.padding)
        elif spec.kind == "pool":
            out_map = dilate_pool(in_map, spec.stride, (Ho, Wo))
        else:
            out_map = torch.ones((in_map.shape[0], Ho, Wo),
                                 dtype=torch.float32, device=in_map.device)
        grid = tile_grid(Ho, Wo)
        t = sites_to_tiles(out_map, grid)
        tiles.append(t)
        in_map = tiles_to_sites(t.to(torch.float32), grid, (Ho, Wo))
    return tuple(tiles)


def layer_window(op: LayerOp, params: EConvParams, vp: torch.Tensor,
                 xyc: torch.Tensor, gate: torch.Tensor, alive: torch.Tensor,
                 tiles: Optional[torch.Tensor] = None):
    """One layer × one whole window for every slot: one fused launch.

    The fused counterpart of T calls of :func:`layer_timestep`, bitwise
    equal to them (membranes and every timestep's spike frame) under both
    dtype policies.  Unlike the reference, which takes time-major
    schedules and transposes them for its kernels, the port passes every
    schedule slot-major: the kernels and :func:`window_common.route_frame`
    both work on it, so no transpose runs between layers.

    Args:
      vp:    (N, Hp, Wp, C) membrane slab in the op's storage dtype.
      xyc:   (N, T, E, 3) int32 events in layer coordinates (conv shifts
             them into halo coordinates here).
      gate:  (N, T, E) gates.
      alive: (N, T) 1.0 where the slot has a real timestep.
      tiles: optional (N, nTx, nTy) tile bitmap (:func:`window_tile_maps`);
             ignored for fc layers.

    Returns ``(vp_new, spikes (N, T, Ho, Wo, C))``, spikes in the
    accumulator dtype.
    """
    spec = op.spec
    check_native_weights(op, params)
    native = op.dtype_policy == INT8_NATIVE
    w = params.w
    if spec.kind == "conv":
        return event_conv_window(vp, w, (xyc + op.event_offset).contiguous(),
                                 gate, alive, lif=op.lif, halo=op.halo,
                                 native=native, tiles=tiles)
    if spec.kind == "pool":
        return event_pool_window(vp, w, xyc, gate, alive, lif=op.lif,
                                 stride=spec.stride, native=native,
                                 tiles=tiles)
    return event_fc_window(vp, w, xyc, gate, alive, lif=op.lif,
                           in_shape=spec.in_shape, native=native)


class LayerWindow(NamedTuple):
    """One layer's fused launch in a window: what it was given and what it
    gave (:func:`fused_window_layers`).  Schedules are slot-major."""
    op: LayerOp
    vp: torch.Tensor                 # (N, Hp, Wp, C) membrane slab in
    xyc: torch.Tensor                # (N, T, E, 3) events, layer coordinates
    gate: torch.Tensor               # (N, T, E)
    alive: torch.Tensor              # (N, T)
    tiles: Optional[torch.Tensor]    # (N, nTx, nTy) bitmap, or None
    vp_new: torch.Tensor             # the slab out
    spikes: torch.Tensor             # (N, T, Ho, Wo, C)
    drops: torch.Tensor              # (N,) int32 events dropped routing in


def fused_window_layers(params: Sequence[EConvParams], states, ev_xyc,
                        ev_gate, alive, pre_dt, *,
                        program: LayerProgram) -> Iterator[LayerWindow]:
    """The fused-window lowering's layer loop, one :class:`LayerWindow`
    per layer (arguments as :func:`window_step`'s).

    Layer-major: layer *l* at timestep *t* needs only layer *l-1*'s frame
    at *t* and its own state, so each layer runs its whole window in one
    :func:`layer_window` launch, and :func:`window_common.route_frame`
    routes all ``N×T`` of its frames in one call (each frame alone, so the
    events and drops are those of T separate calls).
    """
    N = ev_xyc.shape[1]
    states = apply_idle_decay(states, pre_dt, program=program)
    tiles = (window_tile_maps(program, ev_xyc, ev_gate)
             if effective_tile_sparsity(program) else None)
    xyc = ev_xyc.transpose(0, 1).contiguous()          # slot-major
    gate = ev_gate.transpose(0, 1).contiguous()
    alive = alive.transpose(0, 1).contiguous()
    drops = torch.zeros((N,), dtype=torch.int32, device=ev_xyc.device)
    s = None
    for op, p, vp in zip(program.ops, params, states):
        if op.index > 0:
            xyc, gate, n_drop = route_frame(s, op.step_capacity)
            drops = n_drop.sum(dim=1, dtype=torch.int32)
        t_l = None if tiles is None else tiles[op.index]
        vp_new, s = layer_window(op, p, vp, xyc, gate, alive, tiles=t_l)
        yield LayerWindow(op, vp, xyc, gate, alive, t_l, vp_new, s, drops)


def _window_step_fused(params: Sequence[EConvParams], states, class_counts,
                       ev_xyc, ev_gate, alive, pre_dt, *,
                       program: LayerProgram):
    """The fused-window lowering behind :func:`window_step` (L launches)."""
    layers = list(fused_window_layers(params, states, ev_xyc, ev_gate, alive,
                                      pre_dt, program=program))
    counts = torch.stack([lw.gate.sum(dim=(1, 2)).to(torch.float32)
                          for lw in layers])
    drops = torch.stack([lw.drops for lw in layers])
    # class counts stay float32 under every policy (exact integer sums)
    class_counts = class_counts + layers[-1].spikes.sum(
        dim=(1, 2, 3)).to(torch.float32)
    return tuple(lw.vp_new for lw in layers), class_counts, counts, drops


# ---------------------------------------------------------------------------
# The fused-network lowering: the whole program in ONE launch per window.
# ---------------------------------------------------------------------------

def _slab_shape(op: LayerOp) -> Tuple[int, int, int]:
    """One slot's halo-padded membrane slab, (Hp, Wp, C)."""
    Ho, Wo, Co = op.spec.out_shape
    h = op.halo
    return (Ho + 2 * h, Wo + 2 * h, Co)


def _ring_capacity(program: LayerProgram, index: int) -> int:
    """Events the boundary into layer ``index`` (>= 1) can carry: the
    consumer's per-timestep capacity clamped to the producer's frame size,
    as :func:`window_common.route_frame` clamps it."""
    h, w, c = program.ops[index - 1].spec.out_shape
    return min(program.ops[index].step_capacity, h * w * c)


@dataclasses.dataclass(frozen=True)
class NetworkWindowPlan:
    """What one CTA of the fused-network kernel holds for its slot.

    A slot is served by a cluster of ``ctas`` CTAs, each owning a band of
    rows of every conv and pool slab and a share of every fc layer's
    columns.  Shared memory of the widest CTA (``smem_bytes``, the sum of
    the byte fields; the layout is `kernels.network_window.smem_layout`,
    the one the launch uses): its share of every layer's accumulators with
    their site masks, the conv and pool weights, the tile bitmaps, its
    share of a routed frame at one bit per site and its two routed lists
    (one int32 per event), and the event stage with the scan scratch.
    """

    membrane_bytes: int
    weight_bytes: int
    tile_bytes: int
    frame_bytes: int
    stage_bytes: int
    ctas: int

    @property
    def smem_bytes(self) -> int:
        """One CTA's shared memory: what must fit the budget."""
        return (self.membrane_bytes + self.weight_bytes + self.tile_bytes
                + self.frame_bytes + self.stage_bytes)


@functools.lru_cache(maxsize=64)
def network_window_plan(program: LayerProgram) -> NetworkWindowPlan:
    """Price one slot of the fused-network kernel on the card, per CTA.

    Counterpart of the reference's plan, re-derived for Hopper: the
    reference prices a TPU grid step's VMEM, schedule and I/O blocks
    included; here only what one CTA of the slot's cluster keeps in shared
    memory counts against the budget (the schedule, the fc matrices and
    the last layer's frames stay in device memory), and nothing depends on
    the window's length.
    """
    ops = program.ops
    w_isz = torch.empty((), dtype=scatter_dtypes(ops[0])[2]).element_size()
    lay = smem_layout(_net_layers(program),
                      tuple(_slab_shape(op) for op in ops), w_isz)
    return NetworkWindowPlan(
        membrane_bytes=lay.membrane_bytes, weight_bytes=lay.weight_bytes,
        tile_bytes=lay.tile_bytes, frame_bytes=lay.frame_bytes,
        stage_bytes=lay.stage_bytes, ctas=CLUSTER)


def effective_fusion(program: LayerProgram) -> str:
    """The lowering :func:`window_step` really runs for ``program``.

    ``"fused-network"`` becomes ``"fused-window"`` when one slot's
    :func:`network_window_plan` does not fit :data:`SMEM_BUDGET` per CTA (the
    H100's).  :func:`window_step` and the engine's launch accounting both
    ask this one predicate.
    """
    if program.fusion_policy != FUSED_NETWORK:
        return program.fusion_policy
    return (FUSED_NETWORK if network_window_plan(program).smem_bytes
            <= SMEM_BUDGET else FUSED_WINDOW)


def state_bytes(program: LayerProgram, n_slots: int) -> int:
    """Bytes of the membrane slabs the serving engine keeps resident for
    ``n_slots`` slots (:func:`padded_state` at :func:`state_dtype`)."""
    return n_slots * sum(int(np.prod(_slab_shape(op)))
                         * state_dtype(op).itemsize for op in program.ops)


def _block_smem(op: LayerOp, n_slots: int, window: bool) -> int:
    """Shared memory of one block of ``op``'s scatter (``window``: its
    window kernel) launched on ``n_slots`` rows, as the wrapper sizes it."""
    spec = op.spec
    if spec.kind == "conv":
        Hp, Wp, Co = _slab_shape(op)
        K, Ci = spec.kernel, spec.in_shape[2]
        rows, co_blk = conv_plan(n_slots, Hp, Wp, Co, K, Ci, window=window)
        return conv_smem(rows, Wp, co_blk, K, Ci, window=window)
    if spec.kind == "pool":
        return pool_smem(int(np.prod(spec.out_shape)), window=window)
    return FC_SMEM


def window_scratch_bytes(program: LayerProgram, n_timesteps: int,
                         co_blk: int = 128, *, n_slots: int = 8) -> int:
    """Peak shared memory of one thread block among a window step's
    launches, under the lowering :func:`effective_fusion` picks.

    The reference's figure of the same name counts a TPU core's VMEM
    scratch; this one counts, on this card, the shared memory (static
    and dynamic) of one block: the widest block of any per-step or
    fused-window launch of any layer on 1 to ``n_slots`` slot rows, sized
    as the wrappers size it (`kernels.event_conv.ops.conv_plan` and
    ``conv_smem``, `kernels.event_pool.ops.pool_smem`,
    `kernels.event_fc.ops.FC_SMEM`), or one CTA of the fused-network
    megakernel (:func:`network_window_plan`).  It never exceeds the
    card's 232,448-byte opt-in budget.  ``n_timesteps`` and ``co_blk``
    change nothing here: no block holds a timestep axis, and the conv
    plan picks its own channel block.
    """
    fusion = effective_fusion(program)
    if fusion == FUSED_NETWORK:
        return network_window_plan(program).smem_bytes
    window = fusion == FUSED_WINDOW
    return max(_block_smem(op, n, window) for op in program.ops
               for n in range(1, n_slots + 1))


@functools.lru_cache(maxsize=64)
def _net_layers(program: LayerProgram) -> Tuple[NetLayer, ...]:
    """Lower the program's ops into the megakernel's static layer plans."""
    out = []
    for op in program.ops:
        spec = op.spec
        out.append(NetLayer(
            kind=spec.kind, lif=op.lif, halo=op.halo,
            cap=(op.step_capacity if op.index == 0
                 else _ring_capacity(program, op.index)),
            padding=spec.padding if spec.kind == "conv" else 0,
            stride=spec.stride if spec.kind == "pool" else 1,
            in_shape=spec.in_shape))
    return tuple(out)


class NetworkLaunch(NamedTuple):
    """The one fused-network launch of a window: the arguments
    :func:`_window_step_network` hands `kernels.network_window`
    (:func:`network_launch`).  Schedules are slot-major."""
    states: Tuple[torch.Tensor, ...]     # slabs after the deferred decay
    weights: Tuple[torch.Tensor, ...]
    xyc: torch.Tensor                    # (N, T, E0, 3); conv: halo coords
    gate: torch.Tensor                   # (N, T, E0)
    alive: torch.Tensor                  # (N, T)
    layers: Tuple[NetLayer, ...]
    native: bool
    tiles: Optional[Tuple[torch.Tensor, ...]]

    def run(self, fn=network_window):
        """Launch it (or hand it to ``fn``, e.g. the plain version)."""
        return fn(self.states, self.weights, self.xyc, self.gate,
                  self.alive, layers=self.layers, native=self.native,
                  tiles=self.tiles)


def network_launch(params: Sequence[EConvParams], states, ev_xyc, ev_gate,
                   alive, pre_dt, *, program: LayerProgram) -> NetworkLaunch:
    """The fused-network launch of one window (arguments as
    :func:`window_step`'s): the deferred idle decay applied, the tile
    bitmaps built from the collector's events, the schedule slot-major
    and a conv first layer's events in halo coordinates."""
    states = apply_idle_decay(states, pre_dt, program=program)
    tiles = (window_tile_maps(program, ev_xyc, ev_gate)
             if effective_tile_sparsity(program) else None)
    xyc = ev_xyc.transpose(0, 1)
    op0 = program.ops[0]
    if op0.kind == "conv":
        xyc = xyc + op0.event_offset
    return NetworkLaunch(
        tuple(states), tuple(p.w for p in params), xyc.contiguous(),
        ev_gate.transpose(0, 1).contiguous(),
        alive.transpose(0, 1).contiguous(), _net_layers(program),
        program.dtype_policy == INT8_NATIVE, tiles)


def _window_step_network(params: Sequence[EConvParams], states, class_counts,
                         ev_xyc, ev_gate, alive, pre_dt, *,
                         program: LayerProgram):
    """The fused-network lowering behind :func:`window_step` (ONE launch).

    Every layer over every timestep of the window in one
    `kernels.network_window` launch (:func:`network_launch`); only the
    last layer's frames and the per-layer counters leave it.  Bitwise the
    fused-window lowering's results.  When one slot's plan does not fit
    the budget, warns with the sizing and runs the fused-window lowering
    instead (L launches; the engine's launch accounting follows
    :func:`effective_fusion`).
    """
    if effective_fusion(program) != FUSED_NETWORK:
        plan = network_window_plan(program)
        warnings.warn(
            f"fused-network window needs {plan.smem_bytes} bytes of shared "
            f"memory per CTA (membranes {plan.membrane_bytes} + weights "
            f"{plan.weight_bytes} + tile bitmaps {plan.tile_bytes} + routed "
            f"frames {plan.frame_bytes} + event stage {plan.stage_bytes}) > "
            f"budget {SMEM_BUDGET}; falling back to the fused-window lowering "
            f"({len(program.ops)} launches per window)")
        return _window_step_fused(params, states, class_counts, ev_xyc,
                                  ev_gate, alive, pre_dt, program=program)
    v_out, s_last, counts, drops = network_launch(
        params, states, ev_xyc, ev_gate, alive, pre_dt,
        program=program).run()
    # the counters leave the kernel as exact int32; the (L, N) float32
    # counts are an exact cast (values < 2^24)
    class_counts = class_counts + s_last.sum(dim=(1, 2, 3)).to(torch.float32)
    return v_out, class_counts, counts.T.to(torch.float32), drops.T


def window_step(params: Sequence[EConvParams], states, class_counts,
                ev_xyc, ev_gate, alive, pre_dt, *, program: LayerProgram):
    """Advance every slot through one window of timesteps.

    The program's fusion policy picks the lowering: ``"per-step"`` runs
    the chain per timestep, each layer one slot-batched scatter launch
    (L×T launches), with :func:`window_common.route_frame` routing each
    FIRE frame into the next layer's event bucket on the device;
    ``"fused-window"`` runs each layer's whole window in one launch
    (:func:`layer_window`, :func:`_window_step_fused`; L launches);
    ``"fused-network"`` runs the whole window of the whole program in one
    launch (:func:`_window_step_network`), or fused-window when one slot
    does not fit :data:`SMEM_BUDGET` (:func:`effective_fusion`).  All three
    give the same bits.

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
    if str(class_counts.device) != program.device:
        raise ValueError(f"the program serves on {program.device}, the "
                         f"state lives on {class_counts.device}")
    for op, p in zip(program.ops, params):
        check_native_weights(op, p)
    if program.fusion_policy == FUSED_NETWORK:
        return _window_step_network(params, states, class_counts, ev_xyc,
                                    ev_gate, alive, pre_dt, program=program)
    if program.fusion_policy == FUSED_WINDOW:
        return _window_step_fused(params, states, class_counts, ev_xyc,
                                  ev_gate, alive, pre_dt, program=program)
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
                xyc, gate, n_drop = route_frame(s, op.step_capacity)
                drops[op.index] += n_drop
            counts[op.index] += gate.sum(dim=1).to(torch.float32)
            states[op.index], s = layer_timestep(op, p, states[op.index],
                                                 xyc, gate, alive_t)
        # class counts stay float32 under every policy (exact integer sums)
        class_counts = class_counts + s.sum(dim=(1, 2)).to(torch.float32)
    return tuple(states), class_counts, counts, drops


# ---------------------------------------------------------------------------
# The single-stream executor (explicit events, lazy TLU leak, RST).
# ---------------------------------------------------------------------------

def check_on_device(what: str, dev: torch.device, stream: ev.EventStream,
                    params: Sequence[EConvParams]) -> None:
    """Raise unless every field of ``stream`` and every weight lies on
    ``dev``: the single-stream entry points move nothing."""
    for name, t in ([(f"stream field {f}", getattr(stream, f))
                     for f in stream._fields]
                    + [(f"layer {i} weights", p.w)
                       for i, p in enumerate(params)]):
        if t.device != dev:
            raise ValueError(f"{what} runs on {dev}; the {name} lies on "
                             f"{t.device} — move it there first")


def _single_stream_dtype(op: LayerOp, params: EConvParams) -> torch.dtype:
    """The single-stream membrane dtype, which its gates share: the int32
    accumulator for the whole inference under int8-native (the kernels'
    ``(int32, int8, int32 -> int32)`` pairing), the weights' dtype on the
    float carrier.  Refuses soft reset and float weights under
    int8-native."""
    if op.lif.reset_mode != "zero":
        raise ValueError("event path requires reset_mode='zero' (hardware "
                         "semantics; lazy TLU skip is exact only then)")
    check_native_weights(op, params)
    return acc_dtype(op) if op.dtype_policy == INT8_NATIVE else params.w.dtype


def _num(x: float, v: torch.Tensor):
    """A LIF constant as a Python number of ``v``'s kind (integral under
    int8-native), so that an operation with it runs in ``v.dtype`` with no
    fill launch."""
    return float(x) if v.is_floating_point() else int(x)


def _fire_into(op: LayerOp, vp: torch.Tensor, spikes: torch.Tensor) -> None:
    """Finish a timestep on the owned slab ``vp``, in place: clip,
    threshold into ``spikes`` (the flat site row of that timestep), reset.
    `core.lif.fire_and_reset`'s arithmetic in four launches: a fired
    membrane is above a positive threshold, so its ``v·(1 − s)`` is +0."""
    p = op.lif
    v = crop_interior(vp, op.halo)
    if p.state_clip is not None:
        v.clamp_(-_num(p.state_clip, v), _num(p.state_clip, v))
    fired = v >= _num(p.threshold, v)
    spikes.copy_(fired.reshape(-1))
    v.masked_fill_(fired, 0)


def _leak_into(op: LayerOp, vp: torch.Tensor, dt: int) -> None:
    """``dt`` leak steps at once on the owned slab's interior, clipped, in
    place: `core.lif.apply_leak` with its step ``leak·dt`` formed on the
    host in the slab's dtype (a float32 product, as the reference's)."""
    p = op.lif
    v = crop_interior(vp, op.halo)
    step = (float(np.float32(p.leak) * np.float32(dt))
            if v.is_floating_point() else int(p.leak) * dt)
    if p.leak_mode == "toward_zero":
        mag = v.abs().sub_(step).clamp_(min=0)       # max(|v| - step, 0)
        v.sign_().mul_(mag)
    else:
        v.sub_(step)
    if p.state_clip is not None:
        v.clamp_(-_num(p.state_clip, v), _num(p.state_clip, v))


def _scatter_segment(op: LayerOp, params: EConvParams, vp: torch.Tensor,
                     xyc: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """One segment's UPDATE events in one N = 1 launch of the layer's
    scatter kernel (conv events already in halo coordinates)."""
    spec = op.spec
    if spec.kind == "conv":
        return event_conv(vp, params.w, xyc, gate, out_dtype=vp.dtype)
    if spec.kind == "pool":
        return event_pool(vp, params.w, xyc, gate, spec.stride,
                          out_dtype=vp.dtype)
    return event_fc(vp, params.w, xyc, gate, spec.in_shape,
                    out_dtype=vp.dtype)


def _emit(spikes: torch.Tensor, out_shape, out_capacity: int,
          n_timesteps: int) -> ev.EventStream:
    """The output stream of a layer's fire record ``spikes`` (T, Ho·Wo·Co):
    events in time order, each timestep's in row-major ``(x, y, c)``
    order, those past ``out_capacity`` dropped.  Each event's index is the
    cumulative sum of the fires before it — the scan's cursor, restated
    over every timestep at once on the device."""
    Ho, Wo, Co = out_shape
    n_flat = Ho * Wo * Co
    dev = spikes.device
    flat = spikes.reshape(-1)
    k = torch.cumsum(flat, 0) - 1
    dst = torch.where(flat & (k < out_capacity), k,
                      torch.full_like(k, out_capacity))
    src = torch.full((out_capacity + 1,), -1, dtype=torch.int64, device=dev)
    src.index_put_((dst,), torch.arange(flat.numel(), device=dev))
    src = src[:out_capacity]
    valid = src >= 0
    site = src.clamp(min=0) % n_flat

    def field(v, pad):
        return torch.where(valid, v, torch.full_like(v, pad)).to(torch.int32)
    return ev.EventStream(
        t=field(torch.div(src, n_flat, rounding_mode="floor"), n_timesteps),
        x=field(torch.div(site, Wo * Co, rounding_mode="floor"), 0),
        y=field(torch.div(site, Co, rounding_mode="floor") % Wo, 0),
        c=field(site % Co, 0),
        op=torch.full((out_capacity,), ev.OP_UPDATE, dtype=torch.int32,
                      device=dev),
        valid=valid)


def layer_event_forward(op: LayerOp, params: EConvParams,
                        stream: ev.EventStream, out_capacity: int,
                        n_timesteps: int):
    """Consume an event stream through one LayerOp; emit its output stream.

    The reference runs a ``lax.scan`` with one step per event; this
    function restates that scan exactly, segment by segment.  With ``t_evt =
    min(where(valid, t, T), T-1)`` and ``t_eff = cummax(t_evt)`` from
    ``t_cur = 0``, event *i* accumulates into timestep ``t_eff[i]``, and a
    boundary (fire and emit at the old ``t_eff``, leak by the rise, clip)
    falls wherever ``t_eff`` rises — for unsorted streams and invalid
    events mid-stream too; tail padding clamps to ``T-1``, so it adds the
    scan's last boundary.  Each run of equal ``t_eff`` is a segment: a
    valid OP_RST zeroes the whole slab at the segment's last RST, and the
    valid UPDATE events after it go, in stream order, to the layer's N = 1
    scatter kernel in ONE launch.  The host reads the segment table back
    once per layer; the fires are recorded per timestep on the device and
    emitted at the end in one ordered compaction (:func:`_emit`).  Work is
    proportional to the events and the *active* boundaries (the lazy TLU
    leak), and the slab stays on the device.

    Under int8-native the membrane stays int32 for the whole inference
    (clipped only at boundaries); on the float carrier it is in the
    weights' dtype.  The kernels skip gated-off events where the scan adds
    ``w·0``, so only the sign of a zero can differ from it.

    Returns ``(out_stream, membrane interior, EConvStats)``.
    """
    acc = _single_stream_dtype(op, params)
    spec = op.spec
    T = n_timesteps
    dev = stream.t.device
    E = stream.capacity
    Ho, Wo, Co = spec.out_shape
    upd = stream.valid & (stream.op == ev.OP_UPDATE)
    rst = stream.valid & (stream.op == ev.OP_RST)
    t_evt = torch.where(stream.valid, stream.t,
                        torch.full_like(stream.t, T)).clamp(max=T - 1)
    t_eff = (torch.cummax(t_evt.clamp(min=0), 0).values.long() if E
             else t_evt.long())
    idx = torch.arange(E, device=dev)
    none = torch.full_like(idx, -1)

    def per_step(init, src, how):
        return torch.full((T,), init, dtype=torch.int64,
                          device=dev).scatter_reduce_(0, t_eff, src, how)
    # per timestep: first event, last RST, last UPDATE (one host read)
    table = torch.stack([per_step(E, idx, "amin"),
                         per_step(-1, torch.where(rst, idx, none), "amax"),
                         per_step(-1, torch.where(upd, idx, none), "amax")])
    table = table.cpu().numpy()
    xyc = torch.stack([stream.x, stream.y, stream.c], 1).to(torch.int32)
    if spec.kind == "conv":
        xyc = xyc + op.event_offset
    gate = upd.to(acc)
    Hp, Wp = Ho + 2 * op.halo, Wo + 2 * op.halo
    vp = torch.zeros((Hp, Wp, Co), dtype=acc, device=dev)
    spikes = torch.zeros((T, Ho * Wo * Co), dtype=torch.bool, device=dev)
    t_cur = n_bnd = 0
    for ts in np.flatnonzero(table[0] < E):
        start, last_rst, last_upd = (int(v) for v in table[:, ts])
        if ts > t_cur:                                      # a boundary
            _fire_into(op, vp, spikes[t_cur])
            _leak_into(op, vp, int(ts) - t_cur)
            t_cur = int(ts)
            n_bnd += 1
        if last_rst >= 0:
            vp.zero_()
        lo = max(start, last_rst + 1)
        if last_upd >= lo:
            vp = _scatter_segment(op, params, vp, xyc[lo:last_upd + 1],
                                  gate[lo:last_upd + 1])
    _fire_into(op, vp, spikes[t_cur])         # the final flush (t_cur < T)
    out = _emit(spikes, spec.out_shape, out_capacity, T)
    emitted = spikes.sum(dtype=torch.int32)
    n_upd = upd.sum(dtype=torch.int32)
    stats = EConvStats(
        n_update_events=n_upd,
        n_sops=n_upd * spec.updates_per_event(),
        n_out_events=emitted,
        n_dropped=torch.clamp(emitted - out_capacity, min=0),
        n_boundaries=torch.full((), n_bnd, dtype=torch.int32, device=dev))
    return out, crop_interior(vp, op.halo), stats


def _layer_event_forward_plain(op: LayerOp, params: EConvParams,
                               stream: ev.EventStream, out_capacity: int,
                               n_timesteps: int):
    """The reference's scan, line by line, one event at a time over
    :func:`scatter_event` (gated-off events add ``w·0``), with the
    emission cursor of ``fire_emit``.  The plain version the tests hold
    :func:`layer_event_forward` against; a Python loop over events."""
    acc = _single_stream_dtype(op, params)
    spec, p, h = op.spec, op.lif, op.halo
    T = n_timesteps
    Ho, Wo, Co = spec.out_shape
    dev = stream.t.device
    ii = torch.arange(Ho * Wo * Co, dtype=torch.int32, device=dev)
    fx, fy, fc = ii // (Wo * Co), (ii // Co) % Wo, ii % Co
    out = {"t": torch.full((out_capacity,), T, dtype=torch.int32,
                           device=dev),
           "x": torch.zeros((out_capacity,), dtype=torch.int32, device=dev),
           "y": torch.zeros((out_capacity,), dtype=torch.int32, device=dev),
           "c": torch.zeros((out_capacity,), dtype=torch.int32, device=dev),
           "valid": torch.zeros((out_capacity,), dtype=torch.bool,
                                device=dev)}
    emitted = 0                  # the scan's cursor, which it also counts

    def fire_emit(vp, t_fire):
        nonlocal emitted
        v_int = clip_state(crop_interior(vp, h), p)
        v_new, s = fire_and_reset(v_int, p)
        vp = write_cropped(vp, v_new, h)
        mask = s.reshape(-1) > 0
        k = torch.cumsum(mask.to(torch.int64), 0) - 1 + emitted
        ok = mask & (k < out_capacity)
        for name, val in (("t", torch.full_like(fx, t_fire)), ("x", fx),
                          ("y", fy), ("c", fc),
                          ("valid", torch.ones_like(ok))):
            out[name][k[ok]] = val[ok]
        emitted += int(mask.sum())
        return vp

    vp = torch.zeros((Ho + 2 * h, Wo + 2 * h, Co), dtype=acc, device=dev)
    t_cur = n_upd = n_bnd = 0
    for e_t, e_x, e_y, e_c, e_op, e_valid in zip(
            *(getattr(stream, f).tolist() for f in stream._fields)):
        t_evt = min(e_t if e_valid else T, T - 1)
        if t_evt > t_cur:
            vp = fire_emit(vp, t_cur)
            v_int = clip_state(apply_leak(crop_interior(vp, h), p.leak,
                                          t_evt - t_cur, p.leak_mode), p)
            vp = write_cropped(vp, v_int, h)
            n_bnd += 1
        t_cur = max(t_cur, t_evt)
        if e_valid and e_op == ev.OP_RST:
            vp = torch.zeros_like(vp)
        is_upd = bool(e_valid and e_op == ev.OP_UPDATE)
        vp = scatter_event(op, params, vp, e_x, e_y, e_c,
                           torch.full((), int(is_upd), dtype=acc,
                                      device=dev))
        n_upd += int(is_upd)
    vp = fire_emit(vp, min(t_cur, T - 1))

    def i32(n):
        return torch.tensor(n, dtype=torch.int32, device=dev)
    stats = EConvStats(n_update_events=i32(n_upd),
                       n_sops=i32(n_upd * spec.updates_per_event()),
                       n_out_events=i32(emitted),
                       n_dropped=i32(max(emitted - out_capacity, 0)),
                       n_boundaries=i32(n_bnd))
    stream_out = ev.EventStream(
        t=out["t"], x=out["x"], y=out["y"], c=out["c"],
        op=torch.full((out_capacity,), ev.OP_UPDATE, dtype=torch.int32,
                      device=dev),
        valid=out["valid"])
    return stream_out, crop_interior(vp, h), stats


def run_stream(program: LayerProgram, params: Sequence[EConvParams],
               stream: ev.EventStream, capacities: Sequence[int],
               n_timesteps: int):
    """Chain :func:`layer_event_forward` through the whole program;
    ``capacities[i]`` sizes layer *i*'s output buffer.  Returns the final
    output stream and the per-layer :class:`EConvStats` tuple."""
    if len(capacities) != len(program.ops):
        raise ValueError("need one output capacity per layer")
    stats = []
    s = stream
    for op, p, cap in zip(program.ops, params, capacities):
        s, _, st = layer_event_forward(op, p, s, cap, n_timesteps)
        stats.append(st)
    return s, tuple(stats)


# ---------------------------------------------------------------------------
# Dense differentiable forward — the training twin of the event executors.
# ---------------------------------------------------------------------------

def dense_program_forward(program: LayerProgram,
                          params: Sequence[EConvParams],
                          spikes: torch.Tensor, train: bool = False,
                          qat: bool = False):
    """Differentiable dense-frame forward over the compiled op chain.

    ``program.ops`` in order, each op's spec and LIF plan, on dense
    ``(..., T, H, W, C)`` frames through `core.econv.dense_forward`: the
    ``leak -> integrate -> clip -> fire -> reset`` arithmetic the event
    executors run.  ``train=True`` fires through the surrogate-gradient
    `core.lif.spike_fn` (same forward values).  ``qat=True`` fake-quantises
    conv/fc weights onto the layer-shared int4 grid `core.quant.quantize_net`
    lowers onto.  Only the float-carrier program trains.  Returns
    ``(out_spikes, acts)`` like `core.sne_net.dense_apply`.
    """
    if program.dtype_policy != F32_CARRIER:
        raise ValueError(
            f"dense_program_forward trains the {F32_CARRIER!r} datapath; "
            f"got a {program.dtype_policy!r} program — train in the "
            f"carrier domain and lower with core.quant.quantize_net")
    if len(params) != len(program.ops):
        raise ValueError("need one params entry per compiled op")
    x = spikes
    acts = []
    for op, p in zip(program.ops, params):
        if qat and op.kind != "pool":
            p = EConvParams(w=fake_quant_weights(p.w, per_channel=False))
        x, _ = dense_forward(p, op.spec, x, train=train)
        acts.append(x)
    return x, acts
