"""Slot-batched continuous serving of concurrent DVS event streams.

Counterpart of ``repro.serve.event_engine``: the local backend, and the
construction knob that returns the mesh backend
(`serve.mesh_engine.MeshEventServeEngine`) for a mesh policy.  A fixed
set of slots (the SNE engine slices) each hold one request's membranes;
a host-side numpy collector bins every slot's next window of events into
padded per-timestep buckets (overflow past the bucket is dropped and
counted; out-of-range events are dropped and counted apart); all active
slots then advance together through one window step of the compiled
layer program (`core.layer_program.window_step`), whose kernels are the
port's CUDA kernels: by default the fused-window lowering (one launch per
layer per window, tile sparsity on), the fused-network one (one launch per
window) or the per-step one (one per layer per timestep).

**Idle skip.**  A slot whose window holds no input event provably does no
work anywhere in the network (hard resets, ``leak >= 0``), so it skips
the step: its leak is deferred as a per-slot idle-step count and applied
analytically the next time it steps.  The remaining slots are compacted
(slot axis rounded up to a power of two, event axis trimmed to the
window's occupancy on the :func:`event_bucket_ladder`) before the step
and scattered back after it.  Results are bitwise those of the full batch.

The step runs eagerly; membranes and class counts stay on the device
between windows.  A window is three phases (:meth:`EventServeEngine.step`
runs them back to back; `serve.runtime.StreamingRuntime` overlaps them):
collect (host numpy only), launch (the schedule staged through pinned
memory and copied without blocking, the step enqueued on the current
stream, its counters and the finishing slots' class counts queued for a
non-blocking copy back, a CUDA event recorded) and retire (the one wait,
on that event).  One stream orders a window's scatter-back, an
eviction's zeroing and the next window's gather, so nothing in collect or
launch waits on the device.
"""
from __future__ import annotations

import dataclasses
import time
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core.econv import EConvParams
from repro_torch.core.engine import SneConfig
from repro_torch.core.layer_program import (check_native_weights,
                                            compile_program,
                                            effective_fusion, padded_state,
                                            window_step)
from repro_torch.core.lif import supports_idle_skip
from repro_torch.core.policies import (BACKEND_LOCAL, BACKEND_MESH,
                                       FUSED_NETWORK, FUSED_WINDOW,
                                       ExecutionPolicy)
from repro_torch.core.sne_net import SNNSpec
from repro_torch.device import resolve_device
from repro_torch.kernels.window_common import tile_grid
from repro_torch.serve.telemetry import RequestTelemetry, request_telemetry


@dataclasses.dataclass
class EventRequest:
    """One inference over an event recording (the serving unit of work)."""

    uid: int
    stream: ev.EventStream          # time-sorted UPDATE events
    n_timesteps: int
    dropped_at_ingest: int = 0      # overflow counted when the stream was built
    # filled on completion:
    class_counts: Optional[np.ndarray] = None
    prediction: Optional[int] = None
    telemetry: Optional[RequestTelemetry] = None
    done: bool = False
    _validated: bool = dataclasses.field(default=False, repr=False)

    @staticmethod
    def from_dense(uid: int, spikes, capacity: Optional[int] = None
                   ) -> "EventRequest":
        """Build a request from a dense ``(T, H, W, C)`` spike tensor (or
        numpy array); the capacity defaults to the event count rounded up
        to a multiple of 8 (at least 8)."""
        spikes = torch.as_tensor(spikes)
        if capacity is None:
            n = int((spikes != 0).sum())
            capacity = max(8, ((n + 7) // 8) * 8)
        return EventRequest(uid=uid,
                            stream=ev.dense_to_events(spikes, capacity),
                            n_timesteps=int(spikes.shape[0]),
                            dropped_at_ingest=ev.overflow_count(spikes,
                                                                capacity))


@lru_cache(maxsize=32)
def event_bucket_ladder(cap: int) -> Tuple[int, ...]:
    """The event-axis capacity ladder: {8, 12, 16, 24, 32, 48, ...} ≤ cap.

    Power-of-two rungs plus their 1.5x midpoints (at most 1.33x padding);
    ``cap`` itself always ends the ladder.
    """
    vals = []
    v = 8
    while v < cap:
        vals.append(v)
        if v + (v >> 1) < cap:
            vals.append(v + (v >> 1))
        v <<= 1
    vals.append(cap)
    return tuple(vals)


def event_bucket(n: int, cap: int) -> int:
    """Smallest ladder rung >= ``n`` (the per-window event axis ``Eb``)."""
    for v in event_bucket_ladder(cap):
        if v >= n:
            return v
    return cap


@dataclasses.dataclass
class CollectedWindow:
    """One window's host-side collector output, pre-launch.

    Host state only, so a window can be collected while the previous one
    computes.  ``part_idx`` is the participating slot set: active slots
    with timesteps left (the streaming runtime keeps a finished slot
    active until its last window retires).
    """

    xyc: np.ndarray        # (W, N, E0, 3) int32 collector bins
    gate: np.ndarray       # (W, N, E0) f32 validity gates
    alive: np.ndarray      # (W, N) f32 real-timestep mask
    n_win_ev: np.ndarray   # (N,) int64 raw events per slot this window
    max_bucket: int        # largest (slot, timestep) bucket fill
    part_idx: np.ndarray   # participating slot indices


@dataclasses.dataclass
class InflightWindow:
    """A launched window not yet retired.

    ``counts`` and ``drops`` are host tensors (pinned on CUDA) whose
    copies from the device were queued at launch; they hold the window's
    counters once ``ready`` has passed (None on the CPU, where the copies
    are done at once).  :meth:`EventServeEngine._retire_phase` waits on it.
    """

    idx: np.ndarray        # launched slot indices
    n_compact: int         # real batch rows (the rest are dummy tail)
    full_batch: bool       # batch position == slot index (no compaction)
    counts: torch.Tensor   # (L, batch) per-layer consumed events
    drops: torch.Tensor    # (L, batch) inter-layer overflow
    ready: Optional[torch.cuda.Event]


class EventServeEngine:
    """Continuous slot-batched inference over concurrent event streams."""

    def __new__(cls, *args, **kwargs):
        """Dispatch construction on ``policy.backend``.

        ``EventServeEngine(..., policy=ExecutionPolicy(backend="mesh"),
        devices=...)`` returns a `serve.mesh_engine.MeshEventServeEngine`:
        the same constructor arguments and serving surface, the slot axis
        sharded over ``devices``.  ``"local"`` (the default) stays this
        class, the parity oracle.  A local engine is placed with
        ``device=``, a mesh engine with ``devices=``; the other one raises.
        """
        pol = kwargs.get("policy")
        if cls is EventServeEngine and pol is not None \
                and pol.backend == BACKEND_MESH:
            from repro_torch.serve.mesh_engine import MeshEventServeEngine
            cls = MeshEventServeEngine
        mesh = cls is not EventServeEngine
        if mesh and kwargs.get("device") is not None:
            raise ValueError("a mesh engine places its slot shards with "
                             "devices= (a sequence, a count or None), not "
                             "device=")
        if not mesh and kwargs.get("devices") is not None:
            raise ValueError("devices= places the slot shards of the mesh "
                             "backend; a local engine takes device=")
        return super().__new__(cls)

    def __init__(self, spec: SNNSpec, params: Sequence[EConvParams],
                 n_slots: int, window: int = 4,
                 step_capacities: Optional[Sequence[int]] = None,
                 sne_cfg: Optional[SneConfig] = None,
                 n_parallel_slices: Optional[int] = None,
                 policy: Optional[ExecutionPolicy] = None,
                 device=None):
        """Compile the network and allocate the slot state on ``device``.

        ``policy`` (default ``ExecutionPolicy()``: float32 carrier,
        fused-window, idle skip and tile sparsity on) selects dtype policy,
        lowering (``"per-step"``, ``"fused-window"`` or
        ``"fused-network"``), idle skip, tile sparsity and backend: a
        ``"mesh"`` policy makes ``EventServeEngine(...)`` return the mesh
        engine (see :meth:`__new__`).  ``device`` defaults to CUDA and
        raises without a card unless ``"cpu"`` is asked for; ``params``
        must already live there.
        """
        if n_slots < 1 or window < 1:
            raise ValueError("need n_slots >= 1 and window >= 1")
        if n_parallel_slices is not None and n_parallel_slices < 1:
            raise ValueError(f"n_parallel_slices={n_parallel_slices} < 1")
        pol = policy if policy is not None else ExecutionPolicy()
        if pol.backend != BACKEND_LOCAL:
            # unreachable through EventServeEngine(...), whose __new__
            # routes mesh policies to the subclass; loud for direct callers
            raise ValueError(f"EventServeEngine is the {BACKEND_LOCAL!r} "
                             f"backend; policy selects {pol.backend!r}")
        self.device = resolve_device(device)
        self.policy = pol
        self.spec = spec
        self.params = list(params)
        for i, p in enumerate(self.params):
            if p.w.device != self.device:
                raise ValueError(f"params[{i}] lives on {p.w.device}, the "
                                 f"engine serves on {self.device}")
        self.N = n_slots
        self.W = window
        self.dtype_policy = pol.dtype_policy
        self.fusion_policy = pol.fusion_policy
        self.program = compile_program(
            spec, step_capacities=(tuple(step_capacities)
                                   if step_capacities is not None else None),
            policy=pol, device=self.device)
        for op, p in zip(self.program.ops, self.params):
            check_native_weights(op, p)
        self.caps = self.program.step_capacities
        self.cfg = sne_cfg or SneConfig()
        self.n_parallel_slices = n_parallel_slices
        # the lazy skip is exact only for hard resets (see core.lif)
        self.idle_skip = pol.idle_skip and all(
            supports_idle_skip(l.lif) for l in spec.layers)
        L = len(spec.layers)

        self.states = tuple(padded_state(op, n_slots=n_slots,
                                         device=self.device)
                            for op in self.program.ops)
        self.class_counts = torch.zeros((n_slots, spec.n_classes),
                                        dtype=torch.float32,
                                        device=self.device)

        # host-side slot bookkeeping (the collector's view)
        self.slot_req: List[Optional[EventRequest]] = [None] * n_slots
        self.active = np.zeros((n_slots,), bool)
        self.tau = np.zeros((n_slots,), np.int64)        # local time cursor
        self.ptr = np.zeros((n_slots,), np.int64)        # event array cursor
        self._ev: List[Optional[np.ndarray]] = [None] * n_slots  # (M,4) t,x,y,c
        self.acc_counts = np.zeros((L, n_slots), np.float64)
        self.acc_drops = np.zeros((L, n_slots), np.float64)
        # engine-lifetime drops routing INTO each layer (row 0 always 0)
        self.total_drops = np.zeros((L,), np.float64)
        self.collector_drops = np.zeros((n_slots,), np.int64)  # capacity
        self.oor_drops = np.zeros((n_slots,), np.int64)        # out-of-range
        self.windows = np.zeros((n_slots,), np.int64)
        self.admit_time = np.zeros((n_slots,), np.float64)
        self.pending_dt = np.zeros((n_slots,), np.int64)
        self.dense_ts = np.zeros((n_slots,), np.int64)
        self.skipped_windows = np.zeros((n_slots,), np.int64)
        self.stats = {"windows": 0, "admitted": 0, "completed": 0,
                      "evicted": 0, "collector_dropped": 0, "out_of_range_dropped": 0,
                      "step_calls": 0, "kernel_launches": 0,
                      "dense_slot_windows": 0, "skipped_slot_windows": 0,
                      "leak_flushes": 0,
                      "collected_events": 0, "launched_events": 0,
                      "padded_event_slots": 0, "padded_event_slots_pow2": 0,
                      "launch_bytes": 0,
                      # measured input tile occupancy: hot tiles of the
                      # layer-0 tile grid per launched (slot, window), and
                      # the grid's size
                      "hot_tiles": 0, "total_tiles": 0}
        self._tile_grid0 = tile_grid(*spec.in_shape[:2])
        # bucket occupancy histogram: bin 0 = empty, bin b>0 = fills whose
        # power-of-two ceiling is 2^(b-1)
        self.bucket_fill_hist = np.zeros(
            (int(self.caps[0]).bit_length() + 2,), np.int64)
        # slot -> (class-count snapshot on the host, its copy's event):
        # taken at the launch of the window a slot's request finishes with
        self._final_counts: Dict[int, Tuple[torch.Tensor,
                                            Optional[torch.cuda.Event]]] = {}

    # --- helpers -----------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device; on CUDA staged through
        pinned memory and copied without blocking (the caching host
        allocator keeps the pinned block until its copy has run)."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, *tensors: torch.Tensor):
        """Queue copies of device tensors to the host: ``(copies, event)``.

        On CUDA the copies go to pinned tensors without blocking, and hold
        their values once the returned event has passed; on the CPU they
        are done at once and the event is None.
        """
        if self.device.type != "cuda":
            return tuple(t.clone() for t in tensors), None
        out = tuple(torch.empty(t.shape, dtype=t.dtype,
                                pin_memory=True).copy_(t, non_blocking=True)
                    for t in tensors)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return out, ready

    def _zero_slot(self, slot: int) -> None:
        """Zero one slot's membranes and class counts, in stream order."""
        for v in self.states:
            v[slot].zero_()
        self.class_counts[slot].zero_()

    @property
    def n_active(self) -> int:
        """Number of slots currently holding an admitted request."""
        return int(self.active.sum())

    @property
    def n_free(self) -> int:
        """Number of slots available for admission."""
        return self.N - self.n_active

    # --- admission ---------------------------------------------------------

    def validate_request(self, req: EventRequest) -> None:
        """Raise if a request can never be served (UPDATE-only streams)."""
        if req._validated:
            return
        if req.n_timesteps < 1:
            raise ValueError(f"request {req.uid}: n_timesteps < 1")
        s = req.stream
        n_other_op = int(np.sum(s.valid.cpu().numpy()
                                & (s.op.cpu().numpy() != ev.OP_UPDATE)))
        if n_other_op:
            raise ValueError(
                f"request {req.uid}: stream contains {n_other_op} valid "
                f"non-UPDATE events (OP_RST/OP_FIRE); the serving engine "
                f"supports UPDATE-only streams — run such streams through "
                f"repro_torch.core.sne_net.event_apply instead")
        req._validated = True

    def try_admit(self, req: EventRequest,
                  slot: Optional[int] = None) -> bool:
        """Admit into a free slot (the lowest, unless ``slot`` pins one);
        False when the engine is full."""
        free = np.nonzero(~self.active)[0]
        if len(free) == 0:
            return False
        if slot is None:
            slot = int(free[0])
        elif self.active[slot]:
            raise ValueError(f"slot {slot} is occupied")
        self.validate_request(req)
        slot = int(slot)
        s = req.stream
        host = {k: getattr(s, k).cpu().numpy() for k in s._fields}
        keep = host["valid"] & (host["op"] == ev.OP_UPDATE)
        arr = np.stack([host["t"][keep], host["x"][keep], host["y"][keep],
                        host["c"][keep]], axis=1).astype(np.int64)
        arr = arr[np.argsort(arr[:, 0], kind="stable")]  # collector sort
        H, W, C = self.spec.in_shape
        in_range = ((arr[:, 1] >= 0) & (arr[:, 1] < H)
                    & (arr[:, 2] >= 0) & (arr[:, 2] < W)
                    & (arr[:, 3] >= 0) & (arr[:, 3] < C)
                    & (arr[:, 0] >= 0) & (arr[:, 0] < req.n_timesteps))
        self._ev[slot] = arr[in_range]
        self.slot_req[slot] = req
        self.active[slot] = True
        self.tau[slot] = 0
        self.ptr[slot] = 0
        self.acc_counts[:, slot] = 0.0
        self.acc_drops[:, slot] = 0.0
        # out-of-range events are a data-quality loss, counted apart from
        # collector capacity drops
        n_oor = int(np.sum(~in_range))
        self.collector_drops[slot] = 0
        self.oor_drops[slot] = n_oor
        self.stats["out_of_range_dropped"] += n_oor
        self.windows[slot] = 0
        self.pending_dt[slot] = 0
        self.dense_ts[slot] = 0
        self.skipped_windows[slot] = 0
        self.admit_time[slot] = time.time()
        self.stats["admitted"] += 1
        return True

    # --- the collector ------------------------------------------------------

    def _participating(self) -> np.ndarray:
        """Active slots that still have timesteps to serve (under
        :meth:`step` the active set; the streaming runtime keeps a
        finished slot active until its last window retires)."""
        return np.asarray(
            [s for s in np.nonzero(self.active)[0]
             if self.tau[s] < self.slot_req[s].n_timesteps], np.int64)

    def _collect_phase(self) -> Optional[CollectedWindow]:
        """Collect one window of host work, or None if no slot has any.

        Host numpy on host state only: safe while an earlier window is
        still computing on the device.
        """
        part_idx = self._participating()
        if len(part_idx) == 0:
            return None
        return self._collect_window(part_idx)

    def _collect_window(self, part_idx: np.ndarray) -> CollectedWindow:
        """Bin each participating slot's next ``W`` timesteps of events.

        A (slot, timestep) bucket holds at most ``caps[0]`` events; the
        excess is dropped and counted, keeping the lowest row-major sites
        (the on-device router's priority) in arrival order.
        """
        W, N, E0 = self.W, self.N, self.caps[0]
        xyc = np.zeros((W, N, E0, 3), np.int32)
        gate = np.zeros((W, N, E0), np.float32)
        alive = np.zeros((W, N), np.float32)
        n_win_ev = np.zeros((N,), np.int64)
        max_bucket = 0
        Hi, Wi, Ci = self.spec.in_shape
        for slot in part_idx:
            req = self.slot_req[slot]
            arr = self._ev[slot]
            t0 = self.tau[slot]
            n_alive = min(self.W, req.n_timesteps - t0)
            alive[:n_alive, slot] = 1.0
            p = self.ptr[slot]
            end = p + int(np.searchsorted(arr[p:, 0], t0 + n_alive, "left"))
            win = arr[p:end]
            self.ptr[slot] = end
            n_win_ev[slot] = end - p
            bounds = np.searchsorted(win[:, 0],
                                     np.arange(t0, t0 + n_alive + 1))
            for dt in range(n_alive):
                rows = win[bounds[dt]:bounds[dt + 1]]
                if len(rows) > E0:
                    dropped = len(rows) - E0
                    self.collector_drops[slot] += dropped
                    self.stats["collector_dropped"] += dropped
                    key = (rows[:, 1] * Wi + rows[:, 2]) * Ci + rows[:, 3]
                    keep = np.argsort(key, kind="stable")[:E0]
                    keep.sort()
                    rows = rows[keep]
                k = len(rows)
                max_bucket = max(max_bucket, k)
                b = 0 if k == 0 else (k - 1).bit_length() + 1
                self.bucket_fill_hist[
                    min(b, len(self.bucket_fill_hist) - 1)] += 1
                if k:
                    xyc[dt, slot, :k, 0] = rows[:, 1]
                    xyc[dt, slot, :k, 1] = rows[:, 2]
                    xyc[dt, slot, :k, 2] = rows[:, 3]
                    gate[dt, slot, :k] = 1.0
            self.stats["collected_events"] += int(n_win_ev[slot])
        return CollectedWindow(xyc=xyc, gate=gate, alive=alive,
                               n_win_ev=n_win_ev, max_bucket=max_bucket,
                               part_idx=part_idx)

    # --- stepping -----------------------------------------------------------

    def step(self) -> int:
        """Advance all active slots one window; returns #active before.

        The synchronous composition of the phases the streaming runtime
        overlaps: collect, launch (idle slots skip), retire, then finish
        the slots whose request completed.  The runtime's oracle.
        """
        n_active = self.n_active
        if n_active == 0:
            return 0
        col = self._collect_phase()
        if col is None:          # cannot happen under synchronous stepping
            return n_active
        inflight, finished = self._launch_phase(col)
        if inflight is not None:
            self._retire_phase(inflight)
        for slot in finished:
            self._finish(slot)
        return n_active

    def _launch_phase(self, col: CollectedWindow,
                      block_eb: Optional[int] = None
                      ) -> Tuple[Optional[InflightWindow], List[int]]:
        """Launch one collected window and advance the host bookkeeping.

        Enqueues the step and the copies back without waiting on the
        device.  Returns the in-flight window (None when every
        participating slot was idle-skipped) and the slots whose request
        completed with it; their class counts are copied back with the
        window, and callers :meth:`_finish` them only after it retired.
        ``block_eb`` is the mesh backend's global path
        (:meth:`_launch_window`).
        """
        dense_idx = self._select_dense(col)
        inflight = (self._launch_window(dense_idx, col, block_eb)
                    if len(dense_idx) else None)
        finished = self._account_window(col, dense_idx)
        if finished:
            (host,), ready = self._to_host(self.class_counts)
            for slot in finished:
                self._final_counts[slot] = (host, ready)
        return inflight, finished

    def _select_dense(self, col: CollectedWindow) -> np.ndarray:
        """Participating slots that launch this window: with idle skip, a
        slot whose window holds no input event is deferred instead."""
        act_idx = col.part_idx
        if self.idle_skip:
            return act_idx[col.n_win_ev[act_idx] > 0]
        return act_idx

    def _account_window(self, col: CollectedWindow,
                        dense_idx: np.ndarray) -> List[int]:
        """Defer idle slots' leak, advance time cursors, and return the
        slots whose request completed with this window."""
        act_idx = col.part_idx
        for slot in act_idx:
            if slot not in dense_idx:
                self.pending_dt[slot] += int(col.alive[:, slot].sum())
                self.skipped_windows[slot] += 1
        self.stats["dense_slot_windows"] += len(dense_idx)
        self.stats["skipped_slot_windows"] += len(act_idx) - len(dense_idx)
        self.stats["windows"] += 1
        finished = []
        for slot in act_idx:
            self.tau[slot] += min(self.W,
                                  self.slot_req[slot].n_timesteps
                                  - self.tau[slot])
            self.windows[slot] += 1
            if self.tau[slot] >= self.slot_req[slot].n_timesteps:
                finished.append(int(slot))
        return finished

    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        """Round up to a power of two (capped)."""
        return min(1 << max(n - 1, 0).bit_length(), cap)

    def _launch_window(self, idx: np.ndarray, col: CollectedWindow,
                       block_eb: Optional[int] = None) -> InflightWindow:
        """Compact the stepping slots, enqueue the window step and the
        copies of its counters back; wait on nothing.

        Without idle skip this is the full batch (all N slots, full event
        axis) — the reference the compacted path matches bit for bit.
        ``block_eb`` is the mesh backend's global path: the full batch,
        the event axis trimmed to ``block_eb`` (the bucket common to every
        shard), the participating slots outside ``idx`` frozen (gate and
        liveness zeroed, their leak left deferred).  The mesh counts that
        launch once for all its shards, so it adds nothing to this
        engine's launch counters.
        """
        xyc, gate, alive = col.xyc, col.gate, col.alive
        A = len(idx)
        if block_eb is not None:
            gidx, Eb = np.arange(self.N), block_eb
        elif self.idle_skip:
            # slot axis: power-of-two bucket; the dummy tail mirrors slot 0
            # but is gated off and frozen
            Ab = self._bucket(A, self.N)
            gidx = np.concatenate([idx, np.zeros((Ab - A,), idx.dtype)])
            Eb = event_bucket(col.max_bucket, self.caps[0])
            Eb_pow2 = self._bucket(max(col.max_bucket, 8), self.caps[0])
        else:
            gidx = np.arange(self.N)
            Eb = Eb_pow2 = self.caps[0]
        full_batch = len(gidx) == self.N and bool(
            (gidx == np.arange(self.N)).all())
        pos = idx if full_batch else np.arange(A)   # batch positions of idx
        pre = np.zeros((len(gidx),), np.int64)
        if self.idle_skip and self.pending_dt[idx].any():
            pre[pos] = self.pending_dt[idx]
            self.pending_dt[idx] = 0
            self.stats["leak_flushes"] += 1
        xyc_w = np.ascontiguousarray(xyc[:, gidx, :Eb])
        gate_w = np.ascontiguousarray(gate[:, gidx, :Eb])
        alive_w = np.ascontiguousarray(alive[:, gidx])
        # freeze every other batch position: the compaction's dummy tail
        # (it mirrors slot 0) or a full block's idle slots (a slot that
        # does not participate is all zeros already)
        frozen = np.ones((len(gidx),), bool)
        frozen[pos] = False
        gate_w[:, frozen] = 0.0
        alive_w[:, frozen] = 0.0
        if full_batch:
            states_c, cc_c = self.states, self.class_counts
        else:
            gj = self._to_device(gidx)
            states_c = tuple(v.index_select(0, gj) for v in self.states)
            cc_c = self.class_counts.index_select(0, gj)
        states_c, cc_c, counts, drops = window_step(
            self.params, states_c, cc_c, self._to_device(xyc_w),
            self._to_device(gate_w), self._to_device(alive_w),
            self._to_device(pre), program=self.program)
        if full_batch:
            self.states, self.class_counts = tuple(states_c), cc_c
        else:
            real = self._to_device(idx)
            for v, sc in zip(self.states, states_c):
                v[real] = sc[:A]
            self.class_counts[real] = cc_c[:A]
        self.dense_ts[idx] += alive[:, idx].sum(axis=0).astype(np.int64)
        (counts_h, drops_h), ready = self._to_host(counts, drops)
        inflight = InflightWindow(idx=idx, n_compact=A, full_batch=full_batch,
                                  counts=counts_h, drops=drops_h, ready=ready)
        if block_eb is not None:
            return inflight
        self.stats["step_calls"] += 1
        self.stats["launched_events"] += int(
            np.sum(gate_w[:, :A] if not full_batch else gate_w[:, idx]))
        self.stats["padded_event_slots"] += self.W * len(gidx) * Eb
        self.stats["padded_event_slots_pow2"] += self.W * len(gidx) * Eb_pow2
        self.stats["launch_bytes"] += (xyc_w.nbytes + gate_w.nbytes
                                       + alive_w.nbytes)
        # input tile occupancy over the first A batch positions, as the
        # reference counts it (the dummy tail mirrors slot 0)
        nTx, nTy, th, tw = self._tile_grid0
        hot = np.zeros((A, nTx, nTy), bool)
        t_, s_, e_ = np.nonzero(gate_w[:, :A] > 0)
        hot[s_, np.minimum(xyc_w[t_, s_, e_, 0] // th, nTx - 1),
            np.minimum(xyc_w[t_, s_, e_, 1] // tw, nTy - 1)] = True
        self.stats["hot_tiles"] += int(hot.sum())
        self.stats["total_tiles"] += A * nTx * nTy
        self.stats["kernel_launches"] += self._window_launches()
        return inflight

    def _window_launches(self) -> int:
        """Kernel launches of one window step under the lowering that runs
        (a fused-network program over its budget runs fused-window:
        `window_step`'s own predicate)."""
        fusion = effective_fusion(self.program)
        L = len(self.program.ops)
        return (1 if fusion == FUSED_NETWORK
                else L if fusion == FUSED_WINDOW else self.W * L)

    def _retire_phase(self, w: InflightWindow) -> None:
        """Wait for one launched window's counters and account them: the
        only phase that waits on the device."""
        if w.ready is not None:
            w.ready.synchronize()
        counts_np = w.counts.numpy().astype(np.float64)
        drops_np = w.drops.numpy().astype(np.float64)
        idx, A = w.idx, w.n_compact
        if w.full_batch:
            self.acc_counts[:, idx] += counts_np[:, idx]
            self.acc_drops[:, idx] += drops_np[:, idx]
            self.total_drops += drops_np[:, idx].sum(axis=1)
        else:
            self.acc_counts[:, idx] += counts_np[:, :A]
            self.acc_drops[:, idx] += drops_np[:, :A]
            self.total_drops += drops_np[:, :A].sum(axis=1)

    def inter_layer_drops(self) -> dict:
        """Engine-lifetime drop totals per layer boundary (row ``l`` counts
        events dropped routing INTO layer ``l``; row 0 is always 0)."""
        return {
            "inter_layer_dropped": [float(d) for d in self.total_drops],
            "inter_layer_dropped_total": float(self.total_drops.sum()),
            "collector_dropped": self.stats["collector_dropped"],
            "out_of_range_dropped": self.stats["out_of_range_dropped"],
        }

    def padding_waste(self) -> dict:
        """Padded-vs-real event accounting for the capacity buckets (the
        ladder ``Eb`` actually launched vs the power-of-two counterfactual,
        the real events inside, the schedule bytes shipped, and the bucket
        occupancy histogram)."""
        padded = self.stats["padded_event_slots"]
        pow2 = self.stats["padded_event_slots_pow2"]
        real = self.stats["launched_events"]
        hist = self.bucket_fill_hist
        last = int(np.nonzero(hist)[0].max()) + 1 if hist.any() else 0
        return {
            "collected_events": self.stats["collected_events"],
            "launched_events": real,
            "padded_event_slots": padded,
            "padded_event_slots_pow2": pow2,
            "padding_waste_ratio": padded / real if real else float("inf"),
            "padding_waste_ratio_pow2": pow2 / real if real else float("inf"),
            "padding_waste_improvement": pow2 / padded if padded else 1.0,
            "launch_bytes": self.stats["launch_bytes"],
            "bucket_fill_hist": [int(h) for h in hist[:last]],
        }

    def evict_slot(self, slot: int) -> Optional[EventRequest]:
        """Release a slot without completing its request (SLO eviction).

        The slot's state is zeroed without being read, in stream order
        after any launched window that includes it, and the slot is
        admissible again at once.  Returns the evicted request, or None
        if the slot was free.
        """
        req = self.slot_req[slot]
        if req is None:
            return None
        self.slot_req[slot] = None
        self.active[slot] = False
        self._ev[slot] = None
        self._final_counts.pop(slot, None)
        self._zero_slot(slot)
        self.stats["evicted"] += 1
        return req

    def _finish(self, slot: int) -> None:
        """Complete a slot's request from the class counts copied back at
        the launch of its last window, then zero the slot."""
        req = self.slot_req[slot]
        host, ready = self._final_counts.pop(slot)
        if ready is not None:
            ready.synchronize()
        cc = host[slot].numpy().copy()      # no alias of a shared snapshot
        self._zero_slot(slot)
        req.class_counts = cc
        req.prediction = int(np.argmax(cc))
        per_layer = self.acc_counts[:, slot]
        sops = [n * l.updates_per_event()
                for n, l in zip(per_layer, self.spec.layers)]
        sites = sum(l.in_shape[0] * l.in_shape[1] * l.in_shape[2]
                    for l in self.spec.layers)
        req.telemetry = request_telemetry(
            self.cfg, uid=req.uid, n_timesteps=req.n_timesteps,
            n_windows=int(self.windows[slot]),
            per_layer_events=list(per_layer), per_layer_sops=sops,
            input_sites=sites,
            input_dropped=req.dropped_at_ingest
            + int(self.collector_drops[slot]) + int(self.oor_drops[slot]),
            inter_layer_dropped=list(self.acc_drops[:, slot]),
            wall_time_s=time.time() - self.admit_time[slot],
            n_parallel_slices=self.n_parallel_slices,
            n_dense_timesteps=int(self.dense_ts[slot]),
            n_skipped_windows=int(self.skipped_windows[slot]))
        req.done = True
        self.slot_req[slot] = None
        self.active[slot] = False
        self._ev[slot] = None
        self.stats["completed"] += 1

    def run(self, requests: Sequence[EventRequest],
            max_windows: int = 100_000) -> None:
        """Continuous batching: admit as slots free, step until drained.

        The whole queue is validated before any work starts.
        """
        for r in requests:
            self.validate_request(r)
        pending = list(requests)
        for _ in range(max_windows):
            while pending and self.try_admit(pending[0]):
                pending.pop(0)
            if self.step() == 0 and not pending:
                break
        else:
            raise RuntimeError("max_windows exceeded before drain")
