"""Slot-batched continuous serving of concurrent DVS event streams.

Counterpart of ``repro.serve.event_engine`` on the local backend.  A fixed
set of slots (the SNE engine slices) each hold one request's membranes;
a host-side numpy collector bins every slot's next window of events into
padded per-timestep buckets (overflow past the bucket is dropped and
counted; out-of-range events are dropped and counted apart); all active
slots then advance together through one window step of the compiled
layer program (`core.layer_program.window_step`), whose scatters are the
port's CUDA kernels.

**Idle skip.**  A slot whose window holds no input event provably does no
work anywhere in the network (hard resets, ``leak >= 0``), so it skips
the step: its leak is deferred as a per-slot idle-step count and applied
analytically the next time it steps.  The remaining slots are compacted
(slot axis rounded up to a power of two, event axis trimmed to the
window's occupancy on the :func:`event_bucket_ladder`) before the step
and scattered back after it.  Results are bitwise those of the full batch.

The step runs eagerly; membranes and class counts stay on the device
between windows, and the per-window counters are read back once, at
retire.
"""
from __future__ import annotations

import dataclasses
import time
from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import events as ev
from repro_torch.core.econv import EConvParams
from repro_torch.core.engine import SneConfig
from repro_torch.core.layer_program import (check_native_weights,
                                            compile_program, padded_state,
                                            window_step)
from repro_torch.core.lif import supports_idle_skip
from repro_torch.core.policies import BACKEND_LOCAL, ExecutionPolicy
from repro_torch.core.sne_net import SNNSpec
from repro_torch.device import resolve_device
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
class _Collected:
    """One window's host-side collector output, pre-launch."""

    xyc: np.ndarray        # (W, N, E0, 3) int32 collector bins
    gate: np.ndarray       # (W, N, E0) f32 validity gates
    alive: np.ndarray      # (W, N) f32 real-timestep mask
    n_win_ev: np.ndarray   # (N,) int64 raw events per slot this window
    max_bucket: int        # largest (slot, timestep) bucket fill
    part_idx: np.ndarray   # participating slot indices


class EventServeEngine:
    """Continuous slot-batched inference over concurrent event streams."""

    def __init__(self, spec: SNNSpec, params: Sequence[EConvParams],
                 n_slots: int, window: int = 4,
                 step_capacities: Optional[Sequence[int]] = None,
                 sne_cfg: Optional[SneConfig] = None,
                 n_parallel_slices: Optional[int] = None,
                 policy: Optional[ExecutionPolicy] = None,
                 device=None):
        """Compile the network and allocate the slot state on ``device``.

        ``policy`` selects dtype policy, lowering and idle skip; the port
        serves ``fusion_policy="per-step"`` on the ``"local"`` backend
        (other values raise).  ``device`` defaults to CUDA and raises
        without a card unless ``"cpu"`` is asked for; ``params`` must
        already live there.
        """
        if n_slots < 1 or window < 1:
            raise ValueError("need n_slots >= 1 and window >= 1")
        if n_parallel_slices is not None and n_parallel_slices < 1:
            raise ValueError(f"n_parallel_slices={n_parallel_slices} < 1")
        pol = policy if policy is not None else ExecutionPolicy()
        if pol.backend != BACKEND_LOCAL:
            raise NotImplementedError(
                f"backend {pol.backend!r} is not ported to the PyTorch/CUDA "
                f"package yet (ROADMAP Queue A item 8, the multi-device "
                f"backend); use backend={BACKEND_LOCAL!r}")
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
                      "collector_dropped": 0, "out_of_range_dropped": 0,
                      "step_calls": 0,
                      "dense_slot_windows": 0, "skipped_slot_windows": 0,
                      "leak_flushes": 0,
                      "collected_events": 0, "launched_events": 0,
                      "padded_event_slots": 0, "padded_event_slots_pow2": 0,
                      "launch_bytes": 0}
        # bucket occupancy histogram: bin 0 = empty, bin b>0 = fills whose
        # power-of-two ceiling is 2^(b-1)
        self.bucket_fill_hist = np.zeros(
            (int(self.caps[0]).bit_length() + 2,), np.int64)

    # --- helpers -----------------------------------------------------------

    def _reset_slot_state(self, slot: int) -> np.ndarray:
        """Zero one slot's membranes and class counts; return its counts."""
        row = self.class_counts[slot].cpu().numpy().copy()   # no alias
        for v in self.states:
            v[slot].zero_()
        self.class_counts[slot].zero_()
        return row

    @property
    def n_active(self) -> int:
        """Number of slots currently holding an admitted request."""
        return int(self.active.sum())

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
                f"supports UPDATE-only streams")
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
        """Active slots that still have timesteps to serve."""
        return np.asarray(
            [s for s in np.nonzero(self.active)[0]
             if self.tau[s] < self.slot_req[s].n_timesteps], np.int64)

    def _collect_window(self, part_idx: np.ndarray) -> _Collected:
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
        return _Collected(xyc=xyc, gate=gate, alive=alive, n_win_ev=n_win_ev,
                          max_bucket=max_bucket, part_idx=part_idx)

    # --- stepping -----------------------------------------------------------

    def step(self) -> int:
        """Advance all active slots one window; returns #active before.

        Collect, launch (idle slots skip), retire, then finish the slots
        whose request completed.
        """
        n_active = self.n_active
        if n_active == 0:
            return 0
        part_idx = self._participating()
        if len(part_idx) == 0:
            return n_active
        col = self._collect_window(part_idx)
        act_idx = col.part_idx
        dense_idx = (act_idx[col.n_win_ev[act_idx] > 0] if self.idle_skip
                     else act_idx)
        if len(dense_idx):
            self._launch_window(dense_idx, col)
        for slot in self._account_window(col, dense_idx):
            self._finish(slot)
        return n_active

    def _account_window(self, col: _Collected,
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

    def _launch_window(self, idx: np.ndarray, col: _Collected) -> None:
        """Compact the stepping slots, run the window step, read back.

        Without idle skip this is the full batch (all N slots, full event
        axis) — the reference the compacted path matches bit for bit.
        """
        xyc, gate, alive = col.xyc, col.gate, col.alive
        A = len(idx)
        if self.idle_skip:
            # slot axis: power-of-two bucket; the dummy tail mirrors slot 0
            # but is gated off and frozen
            Ab = self._bucket(A, self.N)
            gidx = np.concatenate([idx, np.zeros((Ab - A,), idx.dtype)])
            Eb = event_bucket(col.max_bucket, self.caps[0])
            Eb_pow2 = self._bucket(max(col.max_bucket, 8), self.caps[0])
        else:
            gidx = np.arange(self.N)
            Eb = Eb_pow2 = self.caps[0]
        pre = np.zeros((len(gidx),), np.int64)
        if self.idle_skip and self.pending_dt[idx].any():
            pre[:A] = self.pending_dt[idx]
            self.pending_dt[idx] = 0
            self.stats["leak_flushes"] += 1
        xyc_w = np.ascontiguousarray(xyc[:, gidx, :Eb])
        gate_w = np.ascontiguousarray(gate[:, gidx, :Eb])
        alive_w = np.ascontiguousarray(alive[:, gidx])
        if self.idle_skip and len(gidx) > A:
            gate_w[:, A:] = 0.0
            alive_w[:, A:] = 0.0
        full_batch = len(gidx) == self.N and bool(
            (gidx == np.arange(self.N)).all())
        dev = self.device
        if full_batch:
            states_c, cc_c = self.states, self.class_counts
        else:
            gj = torch.as_tensor(gidx, device=dev)
            states_c = tuple(v.index_select(0, gj) for v in self.states)
            cc_c = self.class_counts.index_select(0, gj)
        states_c, cc_c, counts, drops = window_step(
            self.params, states_c, cc_c,
            torch.from_numpy(xyc_w).to(dev), torch.from_numpy(gate_w).to(dev),
            torch.from_numpy(alive_w).to(dev), torch.from_numpy(pre).to(dev),
            program=self.program)
        if full_batch:
            self.states, self.class_counts = tuple(states_c), cc_c
        else:
            real = torch.as_tensor(idx, device=dev)
            for v, sc in zip(self.states, states_c):
                v[real] = sc[:A]
            self.class_counts[real] = cc_c[:A]
        self.dense_ts[idx] += alive[:, idx].sum(axis=0).astype(np.int64)
        self.stats["step_calls"] += 1
        self.stats["launched_events"] += int(
            np.sum(gate_w[:, :A] if not full_batch else gate_w[:, idx]))
        self.stats["padded_event_slots"] += self.W * len(gidx) * Eb
        self.stats["padded_event_slots_pow2"] += self.W * len(gidx) * Eb_pow2
        self.stats["launch_bytes"] += (xyc_w.nbytes + gate_w.nbytes
                                       + alive_w.nbytes)
        # retire: the one device-to-host read of the window
        counts_np = counts.cpu().numpy().astype(np.float64)
        drops_np = drops.cpu().numpy().astype(np.float64)
        if full_batch:
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

    def _finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        cc = self._reset_slot_state(slot)
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
