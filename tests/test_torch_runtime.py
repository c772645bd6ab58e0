"""The port's streaming runtime: admission, SLO enforcement, pipeline
parity, against the JAX reference and against the port's own synchronous
engine.

* The reference's runtime tests (``tests/test_streaming_runtime.py``),
  ported: clocks, loadgen, percentile, the admission queue, slot
  policies, burst rejection, mid-window eviction and slot reuse, the
  reserved in-flight slot, a finished in-flight slot outliving its
  deadline, expiry in the queue, a zero-event request, least-loaded
  placement, padding waste, refused constructions and the report.
* Cross-package scenarios: the same numpy weights and numpy-made streams
  through the reference ``StreamingRuntime`` (``use_pallas=False``) and
  the port's (``device="cpu"``), both under the same Poisson arrivals and
  a manual clock that moves on every reading, with and without an SLO
  that evicts: every request's lifecycle, times, latencies, class counts
  and telemetry (wall time excluded), the ``report()`` dicts and the
  engines' statistics equal exactly, under both dtype policies and every
  lowering.
* The port's runtime equals the port's synchronous ``run`` bitwise over
  the same matrix; ``poisson_arrival_times``, ``EventRequest.from_dense``
  and ``ReplayClient`` equal the reference's.
* On a card (``gpu`` marker, skipped here): the runtime's collect and
  launch phases run under ``torch.cuda.set_sync_debug_mode("error")`` and
  the results equal the card's synchronous ``run``.  The card's machine
  has no JAX, so this file imports the reference lazily; there run

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_runtime.py
"""
import dataclasses
import importlib
import inspect

import numpy as np
import pytest
import torch

from repro_torch.core.econv import EConvParams
from repro_torch.core.policies import ExecutionPolicy
from repro_torch.core.quant import quantize_net
from repro_torch.core.sne_net import init_snn, tiny_net
from repro_torch.data import events_ds as ds
from repro_torch.serve import EventRequest, EventServeEngine
from repro_torch.serve.runtime import (DONE, EVICTED, EXPIRED, REJECTED,
                                       SLOT_FIFO, SLOT_LEAST_LOADED,
                                       AdmissionQueue, ManualClock,
                                       PoissonLoadGen, StreamingRuntime,
                                       StreamRequest, WallClock, choose_slot,
                                       percentile, poisson_arrival_times,
                                       requests_synthetic)

torch.set_num_threads(1)
WINDOW_US = 1000
# both dtype policies x (fusion, tile sparsity): the default fused-window
# lowering with its bitmaps on and off, fused-network and per-step
POLICIES = [ExecutionPolicy(dtype_policy=d, fusion_policy=f,
                            tile_sparsity=ts)
            for d in ("f32-carrier", "int8-native")
            for f, ts in (("fused-window", True), ("fused-window", False),
                          ("fused-network", True), ("per-step", True))]


def _ids(pol):
    return f"{pol.dtype_policy}-{pol.fusion_policy}" + (
        "" if pol.tile_sparsity else "-dense")


def _ref(name):
    """A module of the JAX reference, imported only where a test needs it
    (the card's machine has no JAX)."""
    return importlib.import_module(name)


def _tiny(n_slots=2, window=4, policy=None, device="cpu"):
    spec = tiny_net()
    pol = policy or ExecutionPolicy()
    qn = quantize_net(init_snn(np.random.default_rng(0), spec,
                               device=device), spec)
    return EventServeEngine(qn.spec, qn.params_for(pol.dtype_policy),
                            n_slots=n_slots, window=window, device=device,
                            policy=pol)


def _fresh(req):
    return dataclasses.replace(req, done=False, class_counts=None,
                               prediction=None, telemetry=None)


def _telemetry(req):
    out = dataclasses.asdict(req.telemetry)
    del out["wall_time_s"]
    return out


def _assert_same_result(a, b, what=""):
    """Two served requests agree exactly (host wall time excluded)."""
    assert a.done and b.done, what
    np.testing.assert_array_equal(np.asarray(a.class_counts),
                                  np.asarray(b.class_counts), err_msg=what)
    assert a.prediction == b.prediction, what
    np.testing.assert_equal(_telemetry(a), _telemetry(b), err_msg=what)


# ---------------------------------------------------------------------------
# clock / loadgen determinism
# ---------------------------------------------------------------------------

def test_manual_clock_semantics():
    c = ManualClock()
    assert c.now() == 0.0
    c.advance(1.5)
    assert c.now() == 1.5
    c.wait_until(3.0)
    assert c.now() == 3.0
    c.wait_until(1.0)                     # no-op when already past
    assert c.now() == 3.0
    with pytest.raises(ValueError):
        c.advance(-0.1)


def test_wall_clock_monotone():
    c = WallClock()
    a, b = c.now(), c.now()
    assert 0.0 <= a <= b


def test_poisson_arrivals_deterministic_and_monotone():
    a = poisson_arrival_times(100.0, 50, seed=7)
    b = poisson_arrival_times(100.0, 50, seed=7)
    np.testing.assert_array_equal(a, b)
    assert np.all(np.diff(a) > 0) and a[0] > 0
    assert not np.array_equal(a, poisson_arrival_times(100.0, 50, seed=8))
    # mean gap within a loose factor of 1/rate
    assert 0.25 / 100.0 < np.diff(a).mean() < 4.0 / 100.0
    with pytest.raises(ValueError):
        poisson_arrival_times(0.0, 3)


@pytest.mark.parametrize("rate_hz,n,seed", [(100.0, 50, 7), (3.5, 9, 0),
                                            (2e4, 200, 123), (1.0, 0, 1)])
def test_poisson_arrival_times_match_reference(rate_hz, n, seed):
    ref = _ref("repro.serve.runtime.loadgen").poisson_arrival_times
    np.testing.assert_array_equal(poisson_arrival_times(rate_hz, n, seed),
                                  ref(rate_hz, n, seed))


def test_loadgen_due_hands_over_in_order_and_stamps_deadlines():
    reqs = requests_synthetic(4, seed=0)
    lg = PoissonLoadGen(reqs, rate_hz=10.0, seed=3, slo_s=0.5)
    assert len(lg) == 4 and not lg.exhausted
    t_all = lg.arrivals[-1]
    out = lg.due(float(t_all))
    assert [s.uid for s in out] == [0, 1, 2, 3]
    assert lg.exhausted and lg.next_arrival_s() is None
    for s in out:
        assert s.deadline_s == pytest.approx(s.arrival_s + 0.5)


def test_requests_synthetic_deterministic_and_real():
    a, b = requests_synthetic(3, seed=5), requests_synthetic(3, seed=5)
    c = requests_synthetic(3, seed=6)
    assert [r.uid for r in a] == [0, 1, 2]
    for x, y, z in zip(a, b, c):
        assert x.n_timesteps == 16
        for f in x.stream._fields:
            assert torch.equal(getattr(x.stream, f), getattr(y.stream, f))
        assert int(x.stream.valid.sum()) > 0
        assert not torch.equal(x.stream.x, z.stream.x)


def test_percentile_edges():
    assert np.isnan(percentile([], 50))
    assert percentile([3.0], 99) == 3.0
    assert percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5


# ---------------------------------------------------------------------------
# admission queue + slot policies
# ---------------------------------------------------------------------------

def _sreq(uid, arrival=0.0, deadline=None):
    return StreamRequest(req=requests_synthetic(1, seed=uid)[0],
                         arrival_s=arrival, deadline_s=deadline)


def test_admission_queue_rejects_when_full():
    q = AdmissionQueue(2)
    a, b, c = _sreq(0), _sreq(1), _sreq(2)
    assert q.offer(a, 0.0) and q.offer(b, 0.0)
    assert not q.offer(c, 1.0)
    assert c.status == REJECTED and c.finish_s == 1.0
    assert len(q) == 2 and q.pop() is a
    with pytest.raises(ValueError):
        AdmissionQueue(0)


def test_admission_queue_expires_past_deadline():
    q = AdmissionQueue(4)
    a = _sreq(0, deadline=1.0)
    b = _sreq(1, deadline=5.0)
    q.offer(a, 0.0)
    q.offer(b, 0.0)
    dropped = q.expire(2.0)
    assert dropped == [a] and a.status == EXPIRED
    assert len(q) == 1 and q.pop() is b


def test_choose_slot_policies():
    free = np.array([1, 3, 4])
    load = np.array([9.0, 5.0, 9.0, 2.0, 2.0])
    assert choose_slot(SLOT_FIFO, free, load) == 1
    # least-loaded: slots 3 and 4 tie at 2.0 -> lowest index wins
    assert choose_slot(SLOT_LEAST_LOADED, free, load) == 3
    with pytest.raises(ValueError, match="unknown slot policy"):
        choose_slot("round-robin", free, load)
    with pytest.raises(ValueError, match="no free slot"):
        choose_slot(SLOT_FIFO, np.array([], np.int64), load)


# ---------------------------------------------------------------------------
# runtime: overload / SLO behaviours (deterministic ManualClock)
# ---------------------------------------------------------------------------

def test_queue_full_rejection_under_burst():
    """A burst beyond queue+slots sheds load gracefully; the rest serve."""
    eng = _tiny(n_slots=1)
    rt = StreamingRuntime(eng, queue_capacity=2, clock=ManualClock())
    sub = rt.submit(requests_synthetic(5, seed=2))   # all arrive at t=0
    assert len([s for s in sub if s.status == REJECTED]) == 3
    rep = rt.serve()
    assert rep["rejected_queue_full"] == 3
    assert rep["completed"] == 2 == rep["admitted"]
    for s in sub:
        if s.status == DONE:
            assert s.req.done and s.req.prediction is not None
        else:
            assert not s.req.done          # rejected work never touched


def _oracle(req, n_slots=1):
    """``req`` served alone on a fresh synchronous engine."""
    oracle = _fresh(req)
    _tiny(n_slots=n_slots).run([oracle])
    return oracle


def test_deadline_eviction_mid_window_and_slot_reuse():
    """A request whose SLO lapses mid-service is evicted while its window
    is in flight, and the freed slot serves the next request with results
    bitwise equal to a fresh engine."""
    eng = _tiny(n_slots=1)
    clock = ManualClock()
    rt = StreamingRuntime(eng, queue_capacity=4, clock=clock)
    victim = requests_synthetic(1, seed=3)[0]
    [sv] = rt.submit([victim], slo_s=0.25)
    assert rt.tick()                       # admit + launch window 1
    assert rt._inflight is not None        # mid-window now
    clock.advance(1.0)                     # ... SLO lapses
    rt.tick()                              # evict, then retire the orphan
    assert sv.status == EVICTED
    assert rt.metrics.evicted_deadline == 1
    assert eng.stats["evicted"] == 1 and eng.n_free == 1
    assert not victim.done
    rt.serve()
    follow = requests_synthetic(1, seed=9)[0]
    [sf] = rt.submit([follow])             # no SLO
    rt.serve()
    assert sf.status == DONE
    _assert_same_result(follow, _oracle(follow))


def test_evicted_inflight_slot_not_readmitted_until_retire():
    """Evicting a mid-flight slot must not hand it to a queued request in
    the same tick (the orphan window's retire would fold the victim's
    counts into the follower's accumulators): the follower's result and
    telemetry equal a fresh engine's."""
    eng = _tiny(n_slots=1)
    clock = ManualClock()
    rt = StreamingRuntime(eng, queue_capacity=4, clock=clock)
    victim = requests_synthetic(1, seed=3)[0]
    follower = dataclasses.replace(requests_synthetic(1, seed=9)[0], uid=1)
    [sv] = rt.submit([victim], slo_s=0.25)
    [sf] = rt.submit([follower])           # queued behind the victim
    assert rt.tick() and rt._inflight is not None
    clock.advance(1.0)                     # victim's SLO lapses mid-window
    rt.tick()                              # evicts, but must NOT re-admit
    assert sv.status == EVICTED
    assert sf.admit_s is None or sf.admit_s > sv.finish_s
    rt.serve()
    assert sf.status == DONE
    _assert_same_result(follower, _oracle(follower))


def test_finished_inflight_slot_survives_deadline_lapse():
    """A request whose final window is in flight has done its compute; a
    deadline lapsing in the one-tick retire gap completes it."""
    eng = _tiny(n_slots=1, window=4)
    H, W, C = eng.spec.in_shape
    spikes = torch.zeros((4, H, W, C))
    spikes[0, 0, 0, 0] = 1.0
    req = EventRequest.from_dense(0, spikes)   # T=4: one window finishes it
    clock = ManualClock()
    rt = StreamingRuntime(eng, queue_capacity=2, clock=clock)
    [sr] = rt.submit([req], slo_s=0.25)
    assert rt.tick()
    assert rt._inflight is not None and rt._inflight.finished == [0]
    clock.advance(1.0)                     # deadline lapses pre-retire
    rt.serve()
    assert sr.status == DONE and req.done
    assert rt.metrics.evicted_deadline == 0
    assert eng.stats["completed"] == 1 and eng.stats["evicted"] == 0


@pytest.mark.parametrize("case", ["slot_policy", "policy_mismatch",
                                  "shared_engine"])
def test_runtime_refuses_bad_construction(case):
    eng = _tiny(n_slots=1)
    if case == "slot_policy":
        with pytest.raises(ValueError, match="unknown slot policy"):
            StreamingRuntime(eng, slot_policy="round-robin")
    elif case == "policy_mismatch":
        with pytest.raises(ValueError, match="policy mismatch"):
            StreamingRuntime(eng, policy=ExecutionPolicy(
                fusion_policy="per-step"))
    else:
        eng.try_admit(requests_synthetic(1, seed=0)[0])
        with pytest.raises(ValueError, match="already has requests"):
            StreamingRuntime(eng)


def test_expired_in_queue_never_occupies_a_slot():
    eng = _tiny(n_slots=1)
    clock = ManualClock()
    rt = StreamingRuntime(eng, queue_capacity=4, clock=clock)
    a, b = requests_synthetic(2, seed=4)
    [sa] = rt.submit([a])                  # occupies the only slot
    [sb] = rt.submit([b], slo_s=0.1)       # waits behind it
    rt.tick()
    clock.advance(1.0)                     # b's deadline passes in queue
    rep = rt.serve()
    assert sb.status == EXPIRED and not b.done
    assert rep["expired_in_queue"] == 1
    assert sa.status == DONE and a.done


def test_zero_event_request_streams_to_completion():
    """An all-silent stream completes under streaming with the same (zero)
    counts as the synchronous oracle: the idle skip must not strand it."""
    eng = _tiny(n_slots=2)
    T, (H, W, C) = eng.spec.n_timesteps, eng.spec.in_shape
    zero = EventRequest.from_dense(0, torch.zeros((T, H, W, C)))
    busy = dataclasses.replace(requests_synthetic(1, seed=5)[0], uid=1)
    rt = StreamingRuntime(eng, clock=ManualClock())
    rt.submit([zero, busy])
    rep = rt.serve()
    assert rep["completed"] == 2
    assert zero.done and np.all(zero.class_counts == 0.0)
    _assert_same_result(zero, _oracle(zero, n_slots=2))


def test_least_loaded_spreads_across_slots():
    """After slot 0 has served work, least-loaded placement prefers the
    colder slot 1; FIFO restarts at slot 0."""
    first = requests_synthetic(1, seed=6)[0]
    second = dataclasses.replace(requests_synthetic(1, seed=7)[0], uid=1)
    for policy, want in ((SLOT_LEAST_LOADED, 1), (SLOT_FIFO, 0)):
        rt = StreamingRuntime(_tiny(n_slots=2), slot_policy=policy,
                              clock=ManualClock())
        rt.submit([_fresh(first)])
        rt.serve()                         # served in slot 0 -> load[0] > 0
        assert rt.slot_load[0] > 0 == rt.slot_load[1]
        [s2] = rt.submit([_fresh(second)])
        rt.serve()
        assert s2.slot == want, policy


def test_padding_waste_accounting():
    """launched <= padded footprint; the histogram counts every bucket the
    collector filled; ratio >= 1 whenever anything launched."""
    rt = StreamingRuntime(_tiny(n_slots=2), clock=ManualClock())
    rt.submit(requests_synthetic(3, seed=8))
    pad = rt.serve()["padding"]
    assert pad["launched_events"] > 0
    assert pad["padded_event_slots"] >= pad["launched_events"]
    assert pad["padding_waste_ratio"] >= 1.0
    assert sum(pad["bucket_fill_hist"]) > 0
    assert all(h >= 0 for h in pad["bucket_fill_hist"])


def test_report_latency_fields_populated():
    rt = StreamingRuntime(_tiny(n_slots=2), clock=ManualClock())
    rt.submit(requests_synthetic(2, seed=1))
    rep = rt.serve()
    assert rep["completed"] == 2
    assert np.isfinite(rep["p50_window_latency_ms"])
    assert rep["p99_window_latency_ms"] >= rep["p50_window_latency_ms"] >= 0
    assert np.isfinite(rep["p99_e2e_latency_ms"])
    assert rep["max_queue_depth"] >= 0
    assert rep["events_served"] > 0
    ref_fields = _ref("repro.serve.runtime.metrics").StreamingMetrics(
        ).summary()
    assert set(rep) == set(ref_fields) | {"padding"}


def test_runtime_takes_no_device_and_serves_on_the_engines():
    assert "device" not in inspect.signature(StreamingRuntime).parameters
    eng = _tiny(n_slots=2)
    rt = StreamingRuntime(eng, clock=ManualClock())
    reqs = requests_synthetic(3, seed=4)
    rt.submit(reqs)
    assert rt.serve()["completed"] == 3
    assert all(v.device == eng.device for v in eng.states)
    assert eng.class_counts.device == eng.device == torch.device("cpu")
    assert all(isinstance(r.class_counts, np.ndarray) for r in reqs)


# ---------------------------------------------------------------------------
# the port's runtime == the port's synchronous run, bitwise, every policy
# ---------------------------------------------------------------------------

def _sync_and_streamed(policy, device, strict=False):
    """Five requests served by the synchronous ``run`` and by the runtime
    under staggered Poisson arrivals (2 slots); with ``strict`` the
    runtime's collect and launch phases run under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    reqs = requests_synthetic(5, seed=11)
    sync_reqs = [_fresh(r) for r in reqs]
    _tiny(n_slots=2, policy=policy, device=device).run(sync_reqs)
    stream_reqs = [_fresh(r) for r in reqs]
    eng = _tiny(n_slots=2, policy=policy, device=device)
    if strict:
        for name in ("_collect_phase", "_launch_phase"):
            setattr(eng, name, _no_sync(getattr(eng, name)))
    rt = StreamingRuntime(eng, queue_capacity=8, clock=ManualClock(),
                          policy=policy)
    rep = rt.serve(PoissonLoadGen(stream_reqs, rate_hz=400.0, seed=2))
    assert rep["completed"] == len(reqs)
    return sync_reqs, stream_reqs


def _no_sync(fn):
    def strict(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return strict


@pytest.mark.parametrize("policy", POLICIES, ids=_ids)
def test_streaming_bitwise_matches_sync_policy_matrix(policy):
    for a, b in zip(*_sync_and_streamed(policy, "cpu")):
        _assert_same_result(a, b, f"uid={a.uid} {policy}")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", POLICIES, ids=_ids)
def test_cuda_streaming_launch_never_waits_and_matches_sync(policy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    for a, b in zip(*_sync_and_streamed(policy, "cuda", strict=True)):
        _assert_same_result(a, b, f"uid={a.uid} {policy}")


# ---------------------------------------------------------------------------
# the port's runtime == the reference's runtime, exactly
# ---------------------------------------------------------------------------

def _both_engines(policy, n_slots=2):
    """The port's engine (CPU) and the reference's (``use_pallas=False``)
    on the same integer weight codes and LIF plan."""
    jlp = _ref("repro.core.lif")
    jecv = _ref("repro.core.econv")
    jpol = _ref("repro.core.policies")
    jnet = _ref("repro.core.sne_net")
    jeng = _ref("repro.serve.event_engine")
    jnp = _ref("jax.numpy")
    spec = tiny_net()
    arrays = [p.w.numpy() for p in init_snn(np.random.default_rng(21), spec,
                                            device="cpu")]
    q = quantize_net([EConvParams(w=torch.from_numpy(a)) for a in arrays],
                     spec)
    jspec = jnet.tiny_net()
    jspec = dataclasses.replace(jspec, layers=tuple(
        dataclasses.replace(jl, lif=jlp.LifParams(**dataclasses.asdict(l.lif)))
        for jl, l in zip(jspec.layers, q.spec.layers)))
    params = q.params_for(policy.dtype_policy)
    caps = (8, 96, 24)    # one event bucket; collector and routing drops
    mine = EventServeEngine(q.spec, params, n_slots, window=4,
                            step_capacities=caps, device="cpu", policy=policy)
    ref = jeng.EventServeEngine(
        jspec, [jecv.EConvParams(w=jnp.asarray(p.w.numpy())) for p in params],
        n_slots, window=4, step_capacities=caps, use_pallas=False,
        policy=jpol.ExecutionPolicy(**dataclasses.asdict(policy)))
    return mine, ref


def _ticking(clock_cls, dt=1e-3):
    """A manual clock that moves ``dt`` on every reading, so serving takes
    clock time and deadlines lapse mid-service, the same in both
    packages as long as both runtimes read the clock at the same points."""
    class Ticking(clock_cls):
        def now(self):
            self._now += dt
            return self._now
    return Ticking()


# a busy stream, a sparse one (idle windows) and ones in between; T = 16
_RECS = [dict(seed=s, rate_hz=r, label=s % 4, duration_us=16 * WINDOW_US)
         for s, r in enumerate((40_000.0, 120.0, 90_000.0, 20_000.0,
                                8_000.0, 60_000.0, 30_000.0))]


def _scenario(mod_ds, mod_rt, engine, slo_s):
    reqs = []
    for i, kw in enumerate(_RECS):
        rec = mod_ds.synthesize_recording(**kw)
        reqs += mod_ds.segment_recording(rec, engine.spec.in_shape, 16,
                                         WINDOW_US, uid_base=i)
    rt = mod_rt.StreamingRuntime(engine, queue_capacity=2,
                                 clock=_ticking(mod_rt.ManualClock))
    rep = rt.serve(mod_rt.PoissonLoadGen(reqs, rate_hz=120.0, seed=5,
                                         slo_s=slo_s))
    return rt, rep


def _lifecycle(sreq):
    return (sreq.uid, sreq.status, sreq.slot, sreq.arrival_s, sreq.deadline_s,
            sreq.admit_s, sreq.finish_s, tuple(sreq.window_latencies_s),
            sreq.req.done)


@pytest.mark.parametrize("policy", POLICIES, ids=_ids)
def test_runtime_matches_reference_runtime(policy):
    """Two scenarios on one pair of engines, each drained before the next:
    no SLO, then an SLO that evicts."""
    mine, ref = _both_engines(policy)
    for slo_s in (None, 0.012):
        rt, rep = _scenario(ds, importlib.import_module(
            "repro_torch.serve.runtime"), mine, slo_s)
        jrt, jrep = _scenario(_ref("repro.data.events_ds"),
                              _ref("repro.serve.runtime"), ref, slo_s)
        what = f"{policy} slo={slo_s}"
        assert [_lifecycle(s) for s in rt.requests] == [
            _lifecycle(s) for s in jrt.requests], what
        for a, b in zip(rt.requests, jrt.requests):
            if a.status == DONE:
                _assert_same_result(a.req, b.req, f"uid={a.uid} {what}")
        np.testing.assert_equal(rep, jrep, err_msg=what)
        assert mine.stats == ref.stats, what
        assert mine.inter_layer_drops() == ref.inter_layer_drops(), what
        # the scenario exercises what it is for: queueing, rejection, idle
        # skips, and with the SLO evictions and expiry beside completions
        assert rep["completed"] > 0 and rep["rejected_queue_full"] > 0
        if slo_s is None:
            assert rep["completed"] + rep["rejected_queue_full"] == len(
                _RECS)
        else:
            assert rep["evicted_deadline"] == mine.stats["evicted"] > 0
            assert rep["expired_in_queue"] > 0
    assert mine.stats["collector_dropped"] > 0
    assert mine.stats["skipped_slot_windows"] > 0


# ---------------------------------------------------------------------------
# EventRequest.from_dense and ReplayClient against the reference
# ---------------------------------------------------------------------------

def _dense_spikes(seed, T=16, shape=(12, 12, 2), p=0.05):
    rng = np.random.default_rng(seed)
    return (rng.random((T,) + shape) < p).astype(np.float32)


@pytest.mark.parametrize("capacity", [None, 8, 40])
def test_from_dense_matches_reference(capacity):
    JReq = _ref("repro.serve.event_engine").EventRequest
    jnp = _ref("jax.numpy")
    spikes = _dense_spikes(3)
    mine = EventRequest.from_dense(7, torch.from_numpy(spikes), capacity)
    ref = JReq.from_dense(7, jnp.asarray(spikes), capacity)
    assert (mine.uid, mine.n_timesteps, mine.dropped_at_ingest) == (
        ref.uid, ref.n_timesteps, ref.dropped_at_ingest)
    for f in mine.stream._fields:
        np.testing.assert_array_equal(getattr(mine.stream, f).numpy(),
                                      np.asarray(getattr(ref.stream, f)),
                                      err_msg=f)
    if capacity == 8:
        assert mine.dropped_at_ingest > 0


def test_replay_client_matches_reference():
    jds = _ref("repro.data.events_ds")
    jnp = _ref("jax.numpy")
    JReq = _ref("repro.serve.event_engine").EventRequest
    policy = ExecutionPolicy()
    mine, ref = _both_engines(policy)
    spikes = [_dense_spikes(s, p=0.03 * (1 + s)) for s in range(4)]
    reqs = [EventRequest.from_dense(i, torch.from_numpy(s))
            for i, s in enumerate(spikes)]
    jreqs = [JReq.from_dense(i, jnp.asarray(s)) for i, s in enumerate(spikes)]
    client = ds.ReplayClient(reqs, n_timesteps=16, window_us=WINDOW_US,
                             speedup=1e6)
    client.run(mine)
    jds.ReplayClient(jreqs, n_timesteps=16, window_us=WINDOW_US,
                     speedup=1e6).run(ref)
    for a, b in zip(reqs, jreqs):
        _assert_same_result(a, b, f"uid={a.uid}")
    assert mine.n_free == mine.N and client.stats["wall_s"] > 0
    with pytest.raises(ValueError, match="speedup"):
        ds.ReplayClient(reqs, 16, WINDOW_US, speedup=0)
