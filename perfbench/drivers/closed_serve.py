"""Closed-loop serving of recorded event streams through the port's
streaming runtime (``StreamingRuntime.tick()`` over ``EventServeEngine``).

The mix fixes the slots, the clients (each sends its next request when its
last one completes), the recording rate and the pool of recordings, drawn
round-robin.  Before the window the loop is desynchronised: client *i*'s
first request is a prefix of (i mod slots + 1) / slots of the recording,
rounded up to whole engine windows, so that completions spread over the
windows instead of coming in waves of a slot-count.  The window opens once
every first request has completed.

``realtime_streams`` is the sensor time served in the window over its wall
time (`perfbench.core.WorkMeter`).  A traced run's window is at most the
mix's ``trace_seconds``.  After the window every request that
completed in it is compared, exactly, with the plain reference on its
recording: class counts and the events that entered each layer.
"""
from __future__ import annotations

import gc
import sys
from collections import Counter

import numpy as np

from perfbench import inputs
from perfbench.core import Outcome, Spans, WorkMeter
from perfbench.program import serving_policy, snn_spec
from perfbench.reference import ecnn
from perfbench.trace import DeviceTrace


def event_stream(events: np.ndarray, n_timesteps: int):
    """The port's ``EventStream`` of binned events (host tensors, padded
    to a multiple of 8 with invalid slots after the last timestep)."""
    import torch
    from repro_torch.core import events as ev
    n = len(events)
    cap = max(8, -(-n // 8) * 8)
    cols = np.zeros((4, cap), np.int32)
    cols[:, :n] = events.T
    cols[0, n:] = n_timesteps
    valid = np.arange(cap) < n
    t, x, y, c = (torch.from_numpy(a) for a in cols)
    return ev.EventStream(t=t, x=x, y=y, c=c,
                          op=torch.full((cap,), ev.OP_UPDATE,
                                        dtype=torch.int32),
                          valid=torch.from_numpy(valid))


def prefix_windows(client: int, slots: int, n_windows: int) -> int:
    """Engine windows in client ``client``'s first request."""
    return -(-n_windows * (client % slots + 1) // slots)


class ClosedLoop:
    """The clients, the engine and the runtime of one run, and the
    accounting that the metrics read."""

    def __init__(self, ctx, pool, qn, spans: Spans, meter: WorkMeter,
                 clock=None):
        from repro_torch.serve import EventServeEngine
        from repro_torch.serve.runtime import StreamingRuntime, WallClock
        cfg, mix = ctx.config, ctx.mix
        self.T, self.W = cfg["n_timesteps"], cfg["serving"]["window"]
        self.slots, self.n_clients = mix["slots"], mix["clients"]
        self.pool = pool
        self.streams = [event_stream(e, self.T) for e in pool]
        policy = serving_policy(cfg)
        self.engine = EventServeEngine(qn.spec,
                                       qn.params_for(policy.dtype_policy),
                                       n_slots=self.slots, window=self.W,
                                       policy=policy, device=ctx.device)
        self.rt = StreamingRuntime(self.engine,
                                   queue_capacity=self.n_clients,
                                   clock=clock or WallClock())
        self.spans, self.meter = spans, meter
        # the work of each launched window, for the traced readers only
        self.keep_work = ctx.trace
        self.next_uid = 0
        self.pool_of = {}                  # uid -> pool index
        self.completed = []                # (time, uid, pool index, request)
        self.failed = 0
        self.launched = []                 # traced: (retire time, [work])
        self._inflight = {}
        self._collected = None
        self.ticks = []                    # (time, requests completed)
        e = self.engine
        spans.wrap(e, "try_admit", "admit")
        spans.wrap(e, "_collect_phase", "collect", self._on_collect)
        spans.wrap(e, "_launch_phase", "launch", self._on_launch)
        spans.wrap(e, "_retire_phase", "retire", self._on_retire)

    # --- accounting, from the wrapped phases ---------------------------------

    def _on_collect(self, col, t0, t1, *args):
        if col is None:
            self._collected = None
            return
        work = None
        if self.keep_work:
            e = self.engine
            work = [(self.pool_of[e.slot_req[s].uid], int(e.tau[s]),
                     int(col.alive[:, s].sum()), int(col.n_win_ev[s]))
                    for s in col.part_idx]
        self._collected = (float(col.alive.sum()), work)

    def _on_launch(self, result, t0, t1, *args):
        inflight, _ = result
        steps, work = self._collected
        if inflight is None:               # every slot idle-skipped
            self.meter.credit(t1, steps)
        else:
            self._inflight[id(inflight)] = (steps, work)

    def _on_retire(self, result, t0, t1, inflight):
        steps, work = self._inflight.pop(id(inflight))
        self.meter.credit(t1, steps)
        if work is not None:
            self.launched.append((t1, [w for w in work if w[3] > 0]))

    # --- the clients -----------------------------------------------------------

    def request(self, n_windows=None):
        """The pool's next recording (round-robin), whole or its first
        ``n_windows`` engine windows."""
        from repro_torch.serve.event_engine import EventRequest
        uid, k = self.next_uid, self.next_uid % len(self.pool)
        self.next_uid += 1
        self.pool_of[uid] = k
        if n_windows is None:
            return EventRequest(uid=uid, stream=self.streams[k],
                                n_timesteps=self.T)
        n_t = min(self.T, n_windows * self.W)
        ev_k = self.pool[k]
        return EventRequest(uid=uid, stream=event_stream(
            ev_k[ev_k[:, 0] < n_t], n_t), n_timesteps=n_t)

    def start(self):
        """Send every client's first request: a prefix of its recording."""
        n_windows = -(-self.T // self.W)
        self.current = self.rt.submit([
            self.request(prefix_windows(i, self.slots, n_windows))
            for i in range(self.n_clients)])
        self.first = set(id(s) for s in self.current)

    def serve_clients(self, now: float) -> None:
        """Send each client whose request ended its next one."""
        from repro_torch.serve.runtime import DONE, QUEUED, RUNNING
        for i, sreq in enumerate(self.current):
            if sreq.status in (QUEUED, RUNNING):
                continue
            if sreq.status == DONE:
                self.completed.append((now, sreq.uid,
                                       self.pool_of[sreq.uid], sreq.req))
            else:
                self.failed += 1
            self.first.discard(id(sreq))
            self.current[i] = self.rt.submit([self.request()])[0]

    def tick(self) -> None:
        """One runtime tick, then the clients whose requests ended."""
        if not self.rt.tick():
            raise RuntimeError("the closed loop drained")
        with self.spans.span("clients"):
            before = len(self.completed)
            now = self.spans.clock()
            self.serve_clients(now)
            self.ticks.append((now, len(self.completed) - before))


def run(ctx) -> Outcome:
    """One run of a closed-loop serving cell."""
    import torch
    from repro_torch.core.econv import EConvParams
    from repro_torch.core.quant import quantize_net
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    clock = ctx.clock
    t_enter = clock()
    layers = inputs.layer_shapes(cfg)
    weights = inputs.make_weights(cfg, ctx.seed, dev)
    qn = quantize_net([EConvParams(w=w) for w in weights], snn_spec(cfg),
                      per_channel=cfg["quantization"]["per_channel"],
                      state_bits=cfg["quantization"]["state_bits"])
    t_weights = clock()
    pool = inputs.recording_pool(cfg, mix, ctx.seed)
    t_inputs = clock()
    spans = Spans(clock)
    meter = WorkMeter(cfg["timestep_us"] * 1e-6)
    loop = ClosedLoop(ctx, pool, qn, spans, meter, clock=ctx.runtime_clock)

    t_engine = clock()
    loop.start()                           # desynchronise; warms every shape
    while loop.first:
        loop.tick()
    print(f"perfbench: set-up: imports {t_enter - ctx.started:.2f} s, "
          f"weights (CUDA start included) {t_weights - t_enter:.2f} s, "
          f"recordings {t_inputs - t_weights:.2f} s, "
          f"engine {t_engine - t_inputs:.2f} s, "
          f"desynchronising {clock() - t_engine:.2f} s in "
          f"{len(loop.ticks)} windows", file=sys.stderr)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    trace = DeviceTrace(ctx.trace)
    ctx.window_opens()
    trace.start()
    # a traced run's window is at most the mix's ``trace_seconds``: reading
    # a trace of ~10^6 device events takes a minute
    seconds = min(ctx.seconds, mix["trace_seconds"]) if ctx.trace \
        else ctx.seconds
    t_open = clock()
    while clock() < t_open + seconds:
        loop.tick()
    t_close = clock()
    trace.stop()
    served = meter.streams(t_open, t_close)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    done = [(pid, req) for t, _, pid, req in loop.completed
            if t_open < t <= t_close]
    attempted, failed = len(done) + loop.failed, loop.failed
    edges = [t_open + (t_close - t_open) * k / 6 for k in range(7)]
    print("perfbench: realtime_streams by sixth of the window: " + ", ".join(
        f"{meter.streams(a, b):.4f}" for a, b in zip(edges, edges[1:])),
        file=sys.stderr)
    per_tick = [n for t, n in loop.ticks if t_open < t <= t_close]
    print(f"perfbench: completions per engine window in the window: "
          f"{len(per_tick)} windows, histogram "
          f"{dict(sorted(Counter(per_tick).items()))}", file=sys.stderr)
    window_launches = [(t, w) for t, w in loop.launched
                       if (trace.t0 or t_open) < t <= (trace.t1 or t_close)]
    span_records = spans.records
    del loop, qn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_answers(layers, weights, pool, cfg, dev,
                            state_bits=cfg["quantization"]["state_bits"])
    checks = compare(done, ref)
    return Outcome(
        end_to_end={"realtime_streams": served},
        readings={"spans": span_records, "trace": trace, "layers": layers,
                  "reference": ref, "launches": window_launches,
                  "engine_window": cfg["serving"]["window"],
                  "window": (trace.t0, trace.t1)},
        checks=checks, attempted=attempted, failed=failed,
        memory_peak_bytes=int(peak))


def reference_answers(layers, weights, pool, cfg, dev, state_bits=8,
                      block=8) -> dict:
    """The reference's class counts, events per layer and timestep, and
    distinct input sites per layer and window, for every pool recording
    (float weights re-quantised by the reference itself)."""
    import torch
    codes, plans = ecnn.quantize(layers, [w.to(dev) for w in weights],
                                 state_bits)
    out = {"class_counts": [], "events": [], "out_events": [],
           "distinct": []}
    for i in range(0, len(pool), block):
        frames = inputs.dense_frames(pool[i:i + block], cfg["n_timesteps"],
                                     tuple(cfg["input"]), dev)
        r = ecnn.serve(layers, codes, plans, frames,
                       cfg["serving"]["window"])
        for k in out:
            out[k].append(r[k].cpu())
        del frames
    return {k: torch.cat(v).numpy() for k, v in out.items()}


def compare(done, ref) -> dict:
    """Every completed request against the reference on its recording:
    requests whose class counts or per-layer events differ, and the widest
    gap in any of them.  No answer to compare is a failure too."""
    bad, gap = 0, 0.0
    for pid, req in done:
        want_cc = ref["class_counts"][pid]
        want_ev = ref["events"][pid].sum(-1)
        got_ev = np.asarray(req.telemetry.per_layer_events, np.float64)
        g = max(float(np.abs(req.class_counts - want_cc).max()),
                float(np.abs(got_ev - want_ev).max()))
        bad += g > 0
        gap = max(gap, g)
    return {"mismatched_answers": (float(bad), 0.0),
            "widest_count_gap": (gap, 0.0),
            "no_answers": (float(len(done) == 0), 0.0)}
