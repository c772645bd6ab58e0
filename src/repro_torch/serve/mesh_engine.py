"""Slot-sharded multi-device serving: the ``backend="mesh"`` engine.

Counterpart of ``repro.serve.mesh_engine``.  The slot axis is split into
D equal shards, one per entry of ``devices`` (`distributed.sharding.
slot_mesh`; a device may repeat).  Every slot's computation is independent
of batch composition, so each request's results are bitwise those of the
local engine, whichever shard serves it.

Callers build ``EventServeEngine(..., policy=ExecutionPolicy(
backend="mesh"), devices=...)``; ``EventServeEngine.__new__`` returns this
subclass, whose phases (`_collect_phase` / `_launch_phase` /
`_retire_phase` / `_finish`) keep the local engine's contracts, so
`EventServeEngine.run` and `serve.runtime.StreamingRuntime` drive it
unchanged.

Layout:

* **shards** — each of the D shards is a full local `EventServeEngine`
  owning ``n_slots / D`` slots on its device: membrane slabs, class
  counts, its compiled program, collector, admission and telemetry.
  Weights are copied once per distinct device; shards on one device share
  the copy.
* **router** — :meth:`MeshEventServeEngine.try_admit` admits each request
  to the least-loaded shard (fewest active slots, lowest index on ties);
  an explicit global slot maps onto (shard, local slot).

Dispatch, per window, by the reference's rule:

* **global path** — when *every* shard has a dense (non-idle) slot.  The
  reference runs one ``shard_map``-ped window step over the whole slot
  axis; here each shard runs what that step's body runs on its device:
  one `window_step` over the shard's whole block (batch position == local
  slot, no compaction), the event axis trimmed to the bucket of the
  largest fill over all shards, idle slots frozen (gate and liveness
  zeroed, their leak left deferred).  Every shard's step is enqueued
  before anything waits.  It counts as one step call in ``stats``, as the
  reference counts its one dispatch; ``stats["device_kernel_launches"]``
  and `kernels.LAUNCHES` count the D launches the devices ran.  With no
  collective behind it, the path keeps the reference's counters and
  padding; it does no less work than the per-shard path.
* **per-shard path** — when some shard has no dense slot: each shard with
  a collected window runs its own `_launch_phase` (its own power-of-two
  compaction); an idle shard launches nothing.

Shards on one CUDA device share its current stream, so their steps run
one after another; on distinct cards they overlap.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.econv import EConvParams
from repro_torch.core.engine import SneConfig
from repro_torch.core.policies import (BACKEND_LOCAL, BACKEND_MESH,
                                       ExecutionPolicy)
from repro_torch.core.sne_net import SNNSpec
from repro_torch.distributed.sharding import (Devices, shard_count,
                                              slot_mesh, visible_cards)
from repro_torch.serve.event_engine import (CollectedWindow, EventRequest,
                                            EventServeEngine, InflightWindow,
                                            event_bucket)


@dataclasses.dataclass
class MeshCollectedWindow:
    """Per-shard collector outputs for one mesh window (pre-launch).

    ``part_idx`` is the *global* participating slot set (the streaming
    runtime snapshots launch-time slot -> request maps from it); ``cols``
    holds each shard's local `CollectedWindow` (None where a shard has
    nothing to serve).
    """

    cols: List[Optional[CollectedWindow]]
    part_idx: np.ndarray


@dataclasses.dataclass
class MeshInflightWindow:
    """One launched mesh window not yet retired: the in-flight window of
    each shard that launched, ``(shard, window)``, on either path.  ``idx``
    is the global launched slot ids, the field the streaming runtime's
    reserved-slot and latency logic reads."""

    idx: np.ndarray
    per_shard: List[Tuple[int, InflightWindow]]


class MeshEventServeEngine(EventServeEngine):
    """Slot-sharded `EventServeEngine` over a sequence of devices."""

    def __init__(self, spec: SNNSpec, params: Sequence[EConvParams],
                 n_slots: int, window: int = 4,
                 step_capacities: Optional[Sequence[int]] = None,
                 sne_cfg: Optional[SneConfig] = None,
                 n_parallel_slices: Optional[int] = None,
                 policy: Optional[ExecutionPolicy] = None,
                 devices: Devices = None):
        """Shard ``n_slots`` over ``devices`` and build one local engine
        per shard.

        The local engine's arguments plus ``devices``: a device sequence
        (repeats allowed), a count of visible cards, or None for the
        largest divisor of ``n_slots`` among the visible cards
        (`distributed.sharding.shard_count`).  An explicit ``devices``
        must divide ``n_slots``.  ``params`` may live on any device.
        """
        pol = policy if policy is not None else ExecutionPolicy(
            backend=BACKEND_MESH)
        if pol.backend != BACKEND_MESH:
            # constructing the subclass directly is itself the choice
            pol = dataclasses.replace(pol, backend=BACKEND_MESH)
        if n_slots < 1 or window < 1:
            raise ValueError("need n_slots >= 1 and window >= 1")
        if devices is None:
            self.devices = slot_mesh(shard_count(n_slots, visible_cards()))
        else:
            self.devices = slot_mesh(devices)
            if n_slots % len(self.devices):
                raise ValueError(
                    f"n_slots={n_slots} does not divide over "
                    f"{len(self.devices)} devices (every shard holds an "
                    f"equal block of slots)")
        self.D = len(self.devices)
        self.spd = n_slots // self.D          # slots per shard
        self.policy = pol
        self.N = n_slots
        self.W = window
        self.spec = spec
        self.params = list(params)
        self.dtype_policy = pol.dtype_policy
        self.fusion_policy = pol.fusion_policy
        self.cfg = sne_cfg or SneConfig()
        self.n_parallel_slices = n_parallel_slices

        local = dataclasses.replace(pol, backend=BACKEND_LOCAL)
        on_device = {}
        self.shards: List[EventServeEngine] = []
        for dev in self.devices:
            if dev not in on_device:
                on_device[dev] = [p._replace(w=p.w.to(dev))
                                  for p in self.params]
            self.shards.append(EventServeEngine(
                spec, on_device[dev], n_slots=self.spd, window=window,
                step_capacities=step_capacities, sne_cfg=sne_cfg,
                n_parallel_slices=n_parallel_slices, policy=local,
                device=dev))
        # shard 0's program stands for all (one spec, one policy); each
        # shard steps with its own, compiled for its device
        self.program = self.shards[0].program
        self.caps = self.shards[0].caps
        self.idle_skip = self.shards[0].idle_skip

        # mesh-level launch accounting on top of the shards' own stats
        # (the aggregate `stats` property folds both together)
        self._extra = {"windows": 0, "step_calls": 0, "kernel_launches": 0,
                       "launched_events": 0, "padded_event_slots": 0,
                       "padded_event_slots_pow2": 0, "launch_bytes": 0,
                       "mesh_global_windows": 0, "mesh_shard_windows": 0}

    def _locate(self, slot: int) -> Tuple[int, int]:
        """A global slot id as (shard, local slot); raise if out of range."""
        if not 0 <= int(slot) < self.N:
            raise ValueError(f"slot {slot} out of range 0..{self.N - 1}")
        return divmod(int(slot), self.spd)

    # --- global views (the EventServeEngine surface) ------------------------

    @property
    def active(self) -> np.ndarray:
        """Global active mask: shard masks concatenated in slot order."""
        return np.concatenate([sh.active for sh in self.shards])

    @property
    def slot_req(self) -> List[Optional[EventRequest]]:
        """Global slot -> request view (a read-only snapshot)."""
        return [r for sh in self.shards for r in sh.slot_req]

    @property
    def windows(self) -> np.ndarray:
        """Per-slot served-window counts, concatenated in slot order."""
        return np.concatenate([sh.windows for sh in self.shards])

    @property
    def tau(self) -> np.ndarray:
        """Per-slot time cursors, concatenated in slot order."""
        return np.concatenate([sh.tau for sh in self.shards])

    @property
    def bucket_fill_hist(self) -> np.ndarray:
        """The shards' collector bucket-occupancy histograms, summed."""
        return np.sum([sh.bucket_fill_hist for sh in self.shards], axis=0)

    @property
    def stats(self) -> dict:
        """Aggregate counters: shard sums plus mesh-level launch counts.

        ``windows`` counts *mesh* windows (one per engine tick, however
        many shards took part); ``mesh_global_windows`` /
        ``mesh_shard_windows`` split them by dispatch path.  Launch
        counters (``step_calls``, ``kernel_launches``, ...) sum the
        shards' own dispatches and the global path's, which counts one
        step call per window as the reference counts its one dispatch.
        ``device_kernel_launches`` counts the launches the devices ran,
        as `kernels.LAUNCHES` does: D per counted launch of the global
        path, plus the shards' own.
        """
        agg = dict.fromkeys(self.shards[0].stats, 0)
        for sh in self.shards:
            for k, v in sh.stats.items():
                agg[k] += v
        own = agg["kernel_launches"]
        for k, v in self._extra.items():
            agg[k] = agg.get(k, 0) + v
        agg["windows"] = self._extra["windows"]
        agg["device_kernel_launches"] = (
            own + self.D * self._extra["kernel_launches"])
        return agg

    # --- admission: the host-side router ------------------------------------

    def try_admit(self, req: EventRequest,
                  slot: Optional[int] = None) -> bool:
        """Admit to the least-loaded shard; False when every shard is full.

        By default the request lands on the shard with the fewest active
        slots (lowest shard index on ties), which keeps the shards' work
        even.  ``slot`` pins a *global* slot id, mapped onto its (shard,
        local slot) pair: the streaming runtime's placement hook.
        """
        if slot is not None:
            s, loc = self._locate(slot)
            return self.shards[s].try_admit(req, slot=loc)
        for s in sorted(range(self.D),
                        key=lambda i: (self.shards[i].n_active, i)):
            if self.shards[s].n_free:
                return self.shards[s].try_admit(req)
        return False

    def evict_slot(self, slot: int) -> Optional[EventRequest]:
        """Release a global slot without completing its request."""
        s, loc = self._locate(slot)
        return self.shards[s].evict_slot(loc)

    # --- the pipeline phases -------------------------------------------------

    def _collect_phase(self) -> Optional[MeshCollectedWindow]:
        """Collect every shard's window (host work only), or None."""
        cols = [sh._collect_phase() for sh in self.shards]
        if all(c is None for c in cols):
            return None
        part = np.concatenate(
            [self.spd * s + c.part_idx
             for s, c in enumerate(cols) if c is not None])
        return MeshCollectedWindow(cols=cols, part_idx=part)

    def _launch_phase(self, col: MeshCollectedWindow
                      ) -> Tuple[Optional[MeshInflightWindow], List[int]]:
        """Launch one mesh window; returns (in-flight, finished slots).

        Every shard with a dense slot: the global path.  Any shard
        entirely idle: the per-shard path, on which the idle shard
        launches nothing.  Nothing here waits on a device.
        """
        self._extra["windows"] += 1
        cols = col.cols
        dense = [sh._select_dense(c) if c is not None
                 else np.empty((0,), np.int64)
                 for sh, c in zip(self.shards, cols)]
        if all(c is not None and len(d) for c, d in zip(cols, dense)):
            return self._launch_global(cols, dense)
        self._extra["mesh_shard_windows"] += 1
        pers: List[Tuple[int, InflightWindow]] = []
        finished: List[int] = []
        for s, (sh, c) in enumerate(zip(self.shards, cols)):
            if c is None:
                continue
            win, fin = sh._launch_phase(c)
            if win is not None:
                pers.append((s, win))
            finished += [self.spd * s + f for f in fin]
        if not pers:
            return None, finished
        idx = np.concatenate([self.spd * s + w.idx for s, w in pers])
        return MeshInflightWindow(idx=idx, per_shard=pers), finished

    def _launch_global(self, cols: List[CollectedWindow],
                       dense: List[np.ndarray]
                       ) -> Tuple[MeshInflightWindow, List[int]]:
        """Enqueue the global path's step on every shard.

        Each shard steps its whole block with the event axis trimmed to
        the bucket of the largest fill over all shards and its idle slots
        frozen (`EventServeEngine._launch_window`'s ``block_eb``), so each
        slot's results match the local engine's.  The launches are
        counted here, once for all shards, as the reference counts its
        one dispatch.
        """
        n = self.spd
        if self.idle_skip:
            mb = max(c.max_bucket for c in cols)
            Eb = event_bucket(mb, self.caps[0])
            Eb_pow2 = EventServeEngine._bucket(max(mb, 8), self.caps[0])
        else:
            Eb = Eb_pow2 = self.caps[0]
        per_shard: List[Tuple[int, InflightWindow]] = []
        finished: List[int] = []
        for s, (sh, c, d) in enumerate(zip(self.shards, cols, dense)):
            win, fin = sh._launch_phase(c, block_eb=Eb)
            per_shard.append((s, win))
            finished += [n * s + f for f in fin]
            self._extra["launched_events"] += int(c.gate[:, d, :Eb].sum())
            self._extra["launch_bytes"] += (c.xyc[:, :, :Eb].nbytes
                                            + c.gate[:, :, :Eb].nbytes
                                            + c.alive.nbytes)
        self._extra["step_calls"] += 1
        self._extra["kernel_launches"] += self.shards[0]._window_launches()
        self._extra["padded_event_slots"] += self.W * self.N * Eb
        self._extra["padded_event_slots_pow2"] += self.W * self.N * Eb_pow2
        self._extra["mesh_global_windows"] += 1
        idx = np.concatenate([n * s + d for s, d in enumerate(dense)])
        return MeshInflightWindow(idx=idx, per_shard=per_shard), finished

    def _retire_phase(self, w: MeshInflightWindow) -> None:
        """Wait for each shard's part of one mesh window and account it."""
        for s, win in w.per_shard:
            self.shards[s]._retire_phase(win)

    def inter_layer_drops(self) -> dict:
        """Engine-lifetime drop totals per boundary, summed over shards."""
        per_shard = [sh.inter_layer_drops() for sh in self.shards]
        total = np.sum([d["inter_layer_dropped"] for d in per_shard], axis=0)
        return {
            "inter_layer_dropped": [float(d) for d in total],
            "inter_layer_dropped_total": float(total.sum()),
            "collector_dropped": sum(d["collector_dropped"]
                                     for d in per_shard),
            "out_of_range_dropped": sum(d["out_of_range_dropped"]
                                        for d in per_shard),
        }

    def _finish(self, slot: int) -> None:
        """Complete a finished request and release its global slot."""
        s, loc = self._locate(slot)
        self.shards[s]._finish(loc)
