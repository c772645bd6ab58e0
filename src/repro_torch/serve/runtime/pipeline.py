"""The streaming runtime: double-buffered continuous-batching serving.

Counterpart of ``repro.serve.runtime.pipeline``.  `EventServeEngine.step`
runs collect -> launch -> retire back to back, so host work and device
compute strictly alternate.  This runtime re-orders those same phases
into a software pipeline around the same window step:

::

    tick t:   [ingest arrivals / SLO checks / admit]   host
              [collect window N+1]                     host   ─┐ overlap
              [launch window N+1]                      enqueue ┤
                  ... window N computing on device ...        ─┘
              [retire window N]                        waits on the device

Window N+1 is collected *and launched* while window N computes: the launch
stages its schedule through pinned memory, enqueues the step and the
non-blocking copies of its counters back on the current CUDA stream and
records an event, so the card runs N and N+1 back to back; the retire of
N waits on N's event and nothing else.  One stream orders each window's
scatter-back, an eviction's zeroing and the next window's gather (what
the reference gets from chained futures).  Because each slot's
computation is independent of batch composition and admission order is
queue-FIFO, streaming outputs are **bitwise identical per request** to the
synchronous engine under every dtype/fusion policy — ``EventServeEngine.run``
is the parity oracle and the tests hold the runtime to it.

On top of the pipeline sits the admission layer
(`repro_torch.serve.runtime.admission`): a bounded queue with graceful
rejection under overload, per-request SLO deadlines with queued-expiry
and mid-service eviction, and a pluggable slot-placement policy.  All
timing flows through an injected clock (`repro_torch.serve.runtime.clock`),
so the same loop serves open-loop Poisson load against wall time and runs
deterministically under tests.  The runtime takes no device: it serves on
its engine's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.event_engine import (EventRequest, EventServeEngine,
                                            InflightWindow)
from repro_torch.serve.runtime.admission import (DONE, EVICTED, REJECTED,
                                                 RUNNING, SLOT_FIFO,
                                                 SLOT_POLICIES,
                                                 AdmissionQueue,
                                                 StreamRequest, choose_slot)
from repro_torch.serve.runtime.clock import WallClock
from repro_torch.serve.runtime.loadgen import PoissonLoadGen
from repro_torch.serve.runtime.metrics import StreamingMetrics


@dataclasses.dataclass
class _Pending:
    """One launched window the pipeline has not yet retired.

    ``slot_reqs`` snapshots slot -> request at launch time, so retire-time
    accounting (window latency, completion) always reaches the requests
    the window actually served — never a later occupant of the slot.
    """

    win: Optional[InflightWindow]
    finished: List[int]          # slots whose request completed this window
    t_launch: float              # clock time at launch
    slot_reqs: Dict[int, StreamRequest]

    def slots(self) -> set:
        """Every slot this window references (launched or finishing)."""
        out = set(self.finished)
        if self.win is not None:
            out.update(int(s) for s in self.win.idx)
        return out


class StreamingRuntime:
    """Continuous-batching async serving around one `EventServeEngine`.

    The engine stays the single compute core (same compiled program, same
    window step, same collector, same device); the runtime owns arrival
    ingestion, the bounded admission queue, SLO enforcement, the
    double-buffered pipeline, and the latency/throughput telemetry.
    """

    def __init__(self, engine: EventServeEngine, queue_capacity: int = 16,
                 slot_policy: str = SLOT_FIFO, clock=None, policy=None):
        if policy is not None and policy != engine.policy:
            # the engine is the single owner of execution policy; a
            # mismatched expectation here would silently serve under the
            # wrong dtype/fusion/backend, so refuse loudly instead
            raise ValueError(
                f"policy mismatch: runtime asked for {policy}, engine "
                f"was built with {engine.policy}")
        if engine.n_active:
            raise ValueError("engine already has requests in flight; the "
                             "runtime must own the full slot lifecycle")
        if slot_policy not in SLOT_POLICIES:
            raise ValueError(f"unknown slot policy {slot_policy!r} "
                             f"(expected one of {SLOT_POLICIES})")
        self.engine = engine
        self.queue = AdmissionQueue(queue_capacity)
        self.slot_policy = slot_policy
        self.clock = clock if clock is not None else WallClock()
        self.metrics = StreamingMetrics()
        self.requests: List[StreamRequest] = []   # every request ever seen
        self.running: Dict[int, StreamRequest] = {}
        self.slot_load = np.zeros((engine.N,), np.float64)
        self._inflight: Optional[_Pending] = None

    # --- request intake -----------------------------------------------------

    def submit(self, requests: Sequence[EventRequest],
               slo_s: Optional[float] = None) -> List[StreamRequest]:
        """Enqueue payloads arriving *now* (the closed-form intake path).

        The loadgen path (:meth:`serve` with a
        :class:`~repro_torch.serve.runtime.loadgen.PoissonLoadGen`) is the
        open-loop twin; this one is for parity tests and batch replays
        where every request is already present.  Queue-full rejection
        applies exactly as for open-loop arrivals.
        """
        now = self.clock.now()
        out = []
        for r in requests:
            sreq = StreamRequest(
                req=r, arrival_s=now,
                deadline_s=(now + slo_s if slo_s is not None else None))
            self._ingest(sreq, now)
            out.append(sreq)
        return out

    def _ingest(self, sreq: StreamRequest, now: float) -> None:
        """Track one arrival and offer it to the bounded queue."""
        self.requests.append(sreq)
        if not self.queue.offer(sreq, now):
            self.metrics.rejected_queue_full += 1

    # --- the pipeline tick --------------------------------------------------

    def tick(self, loadgen: Optional[PoissonLoadGen] = None) -> bool:
        """One pipeline iteration; returns False when fully drained.

        Phase order is the pipeline diagram in the module docstring:
        intake/SLO/admission first (host), then collect AND launch the
        next window (host work and an enqueue, both overlapping the
        in-flight device window), then retire the in-flight window (the
        only wait on the device).
        """
        now = self.clock.now()
        if loadgen is not None:
            for sreq in loadgen.due(now):
                self._ingest(sreq, now)
        self.metrics.expired_in_queue += len(self.queue.expire(now))
        self._evict_deadline_missed(now)
        self._admit(now)
        self.metrics.queue_depth_samples.append(len(self.queue))

        # Collect AND launch window k+1 before waiting on window k: the
        # launch only enqueues, so the device runs k and k+1 back-to-back
        # while the host does the retire bookkeeping for k.  Collection
        # precedes the retire either way, so launching early costs no
        # slot occupancy.
        col = self.engine._collect_phase()     # overlaps device compute
        launched = None
        if col is not None:
            win, finished = self.engine._launch_phase(col)
            launched = _Pending(
                win=win, finished=finished, t_launch=self.clock.now(),
                slot_reqs={int(s): self.running[int(s)]
                           for s in col.part_idx
                           if int(s) in self.running})
        self._retire_inflight()                # the only wait on the device
        if launched is not None:
            if launched.win is None:
                # all-idle window, nothing launched; its completed slots
                # can finish now that the prior window's retire has landed
                # their accumulator updates
                self._finish_slots(launched.finished)
            else:
                self._inflight = launched

        busy = (bool(self.running) or self._inflight is not None
                or len(self.queue) > 0
                or (loadgen is not None and not loadgen.exhausted))
        if not busy:
            return False
        if (col is None and self._inflight is None and len(self.queue) == 0
                and loadgen is not None and not loadgen.exhausted):
            # drained ahead of the arrival process: wait for the next one
            nxt = loadgen.next_arrival_s()
            if nxt is not None:
                self.clock.wait_until(nxt)
        return True

    def serve(self, loadgen: Optional[PoissonLoadGen] = None,
              max_ticks: int = 1_000_000) -> Dict:
        """Run the pipeline to drain; returns :meth:`report`.

        With a loadgen this is the open-loop serve loop (arrivals keep
        coming whether or not the engine keeps up); without one it
        drains whatever :meth:`submit` enqueued.
        """
        t0 = self.clock.now()
        ev0 = self.engine.stats["collected_events"]
        for _ in range(max_ticks):
            if not self.tick(loadgen):
                break
        else:
            raise RuntimeError("max_ticks exceeded before drain")
        self.metrics.span_s += self.clock.now() - t0
        self.metrics.events_served += (self.engine.stats["collected_events"]
                                       - ev0)
        return self.report()

    def report(self) -> Dict:
        """Streaming summary + the engine's padding-waste accounting."""
        out = self.metrics.summary(self.requests)
        out["padding"] = self.engine.padding_waste()
        return out

    # --- admission / SLO internals ------------------------------------------

    def _reserved_slots(self) -> set:
        """Slots the in-flight window references — off-limits until retire.

        An evicted in-flight slot looks free to the engine, but admitting
        into it before the window retires would let the retire phase fold
        the old request's counts into the new request's accumulators (and
        a finished in-flight slot would complete the new request with the
        old one's results).  Admission skips these for one tick.
        """
        return self._inflight.slots() if self._inflight is not None else set()

    def _evict_deadline_missed(self, now: float) -> None:
        """Reclaim slots whose request can no longer meet its deadline.

        Mid-service eviction: the slot's state reset is enqueued after any
        in-flight window's writes (see `EventServeEngine.evict_slot`),
        so eviction is safe even while the slot is part of the window
        currently computing on device.  Slots whose request *completed*
        with the in-flight window are exempt: their compute is done and
        only the retire bookkeeping is pending, so a deadline lapsing in
        that one-tick gap must not discard a finished result.
        """
        finished_inflight = (set(self._inflight.finished)
                             if self._inflight is not None else set())
        for slot, sreq in list(self.running.items()):
            if slot in finished_inflight:
                continue
            if sreq.deadline_s is not None and now > sreq.deadline_s:
                self.engine.evict_slot(slot)
                sreq.status = EVICTED
                sreq.finish_s = now
                del self.running[slot]
                self.metrics.evicted_deadline += 1

    def _admit(self, now: float) -> None:
        """Move queue heads into free slots (FIFO order, policy placement)."""
        reserved = self._reserved_slots()
        while len(self.queue) > 0:
            free = np.asarray([s for s in np.nonzero(~self.engine.active)[0]
                               if int(s) not in reserved], np.int64)
            if len(free) == 0:
                break
            slot = choose_slot(self.slot_policy, free, self.slot_load)
            sreq = self.queue.pop()
            try:
                self.engine.try_admit(sreq.req, slot=slot)
            except ValueError:
                # malformed stream: mark it rejected instead of crashing
                # the serve loop (it stays visible in self.requests)
                sreq.status = REJECTED
                sreq.finish_s = now
                continue
            sreq.status = RUNNING
            sreq.slot = slot
            sreq.admit_s = now
            self.running[slot] = sreq
            self.metrics.admitted += 1

    # --- pipeline internals -------------------------------------------------

    def _retire_inflight(self) -> None:
        """Retire the in-flight window: wait, account, attribute latency."""
        if self._inflight is None:
            return
        p = self._inflight
        self.engine._retire_phase(p.win)       # waits for the window's event
        now = self.clock.now()
        lat = now - p.t_launch
        self.metrics.window_latencies_s.append(lat)
        for slot in p.win.idx:
            # launch-time attribution: the requests this window actually
            # served, not whatever occupies the slot at retire time
            sreq = p.slot_reqs.get(int(slot))
            if sreq is not None:
                sreq.window_latencies_s.append(lat)
        self._finish_slots(p.finished)
        self._inflight = None

    def _finish_slots(self, finished: Sequence[int]) -> None:
        """Complete and release slots whose last window has retired."""
        for slot in finished:
            if self.engine.slot_req[slot] is None:
                continue                       # evicted while in flight
            self.slot_load[slot] += float(self.engine.windows[slot])
            self.engine._finish(slot)
            sreq = self.running.pop(slot, None)
            if sreq is not None:
                sreq.status = DONE
                sreq.finish_s = self.clock.now()
                self.metrics.completed += 1
