"""The port's mesh serving backend (``backend="mesh"``) against the JAX
reference.

* Inputs are the reference mesh test's (``tests/test_mesh_serving.py``):
  ``tiny_net(n_timesteps=12)`` from ``jax.random.PRNGKey(0)``, quantised;
  6 requests at 4% activity from ``np.random.default_rng(0)``, request 3
  idle after t = 4.  The integer codes cross to the port through
  ``weights.params_from_numpy``.
* Every (dtype x lowering) mesh policy at D = 1, 2 and 4 shards on
  repeated ``"cpu"`` devices, and one case with idle skip off, equals the
  reference's *local* engine (``use_pallas=False``) request for request,
  bitwise: class counts, prediction and the telemetry counters.
* At D = 1 the port's ``stats`` equal the reference ``MeshEventServeEngine``
  key for key (the dispatch-path split and launch counters included),
  beside the port's own ``device_kernel_launches``.
* Behaviour with repeated devices: the construction knob, the
  least-loaded router, explicit slots and eviction, an idle shard that
  launches nothing, the divisibility rule, the auto-pick rule, the
  runtime's policy check, the runtime over the mesh == the synchronous
  run, and one run that takes both dispatch paths.
* On a card (``gpu`` marker, skipped here): the D = 2 mesh on ``cuda:0``
  equals the local engine on the card under every lowering, with collect
  and launch under ``torch.cuda.set_sync_debug_mode("error")``.  The card's
  machine has no JAX, so this file imports the reference lazily; there run

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_mesh.py
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core.lif import LifParams
from repro_torch.core.policies import ExecutionPolicy, all_policies
from repro_torch.core.quant import quantize_net
from repro_torch.core.sne_net import init_snn, tiny_net
from repro_torch.distributed import shard_count, slot_mesh
from repro_torch.kernels import LAUNCHES, reset_launch_counts
from repro_torch.serve import (EventRequest, EventServeEngine,
                               MeshEventServeEngine)
from repro_torch.serve.runtime import (ManualClock, PoissonLoadGen,
                                       StreamingRuntime)
from repro_torch.weights import params_from_numpy

torch.set_num_threads(1)
T_STEPS = 12
MESH_POLICIES = [p for p in all_policies() if p.backend == "mesh"]
TELEMETRY = ("per_layer_events", "inter_layer_dropped", "n_windows",
             "n_dense_timesteps", "n_skipped_windows", "input_dropped")


def _ref(name):
    """A module of the JAX reference, imported only where a test needs it
    (the card's machine has no JAX)."""
    return importlib.import_module(name)


@pytest.fixture(scope="module")
def ref_net():
    jax = _ref("jax")
    jnet = _ref("repro.core.sne_net")
    spec = jnet.tiny_net(n_timesteps=T_STEPS)
    return _ref("repro.core.quant").quantize_net(
        jnet.init_snn(jax.random.PRNGKey(0), spec), spec)


@pytest.fixture(scope="module")
def net(ref_net):
    """The port's spec (the reference's quantised LIF plan) and its params
    per dtype policy, from the reference's integer codes."""
    base = tiny_net(n_timesteps=T_STEPS)
    spec = dataclasses.replace(base, layers=tuple(
        dataclasses.replace(l, lif=LifParams(**dataclasses.asdict(jl.lif)))
        for l, jl in zip(base.layers, ref_net.spec.layers)))
    f32 = params_from_numpy(
        [np.array(p.w) for p in ref_net.params_for("f32-carrier")], spec,
        device="cpu")
    params = {"f32-carrier": f32,
              "int8-native": [p._replace(w=p.w.to(torch.int8)) for p in f32]}
    return spec, params


@pytest.fixture(scope="module")
def spikes():
    rng = np.random.default_rng(0)
    s = (rng.random((6, T_STEPS, 12, 12, 2)) < 0.04).astype(np.float32)
    s[3, 4:] = 0.0       # an all-idle tail: idle skip and frozen rows
    return s


def _requests(spikes):
    return [EventRequest.from_dense(i, spikes[i]) for i in range(len(spikes))]


def _serve(net, spikes, policy, n_slots=4, **kw):
    spec, params = net
    eng = EventServeEngine(spec, params[policy.dtype_policy], n_slots=n_slots,
                           window=4, policy=policy, **kw)
    reqs = _requests(spikes)
    eng.run(reqs)
    return reqs, eng


def _mesh(net, n_slots, D, policy=None):
    spec, params = net
    pol = policy or ExecutionPolicy(backend="mesh")
    return EventServeEngine(spec, params[pol.dtype_policy], n_slots=n_slots,
                            window=4, policy=pol, devices=["cpu"] * D)


_REF_LOCAL = {}


def _ref_local(ref_net, spikes, policy):
    """The reference's local engine on the same requests, under the
    policy's dtype and idle skip and the default lowering: the reference
    holds its three lowerings bitwise equal (``tests/test_fused_window.py``,
    ``tests/test_network_window.py``), and each run compiles, so one run
    per (dtype, idle skip) is cached."""
    jpol = _ref("repro.core.policies")
    jserve = _ref("repro.serve")
    key = ExecutionPolicy(dtype_policy=policy.dtype_policy,
                          idle_skip=policy.idle_skip)
    if key not in _REF_LOCAL:
        eng = jserve.EventServeEngine(
            ref_net.spec, ref_net.params_for(key.dtype_policy), n_slots=4,
            window=4, use_pallas=False,
            policy=jpol.ExecutionPolicy(**dataclasses.asdict(key)))
        reqs = [jserve.EventRequest.from_dense(i, spikes[i])
                for i in range(len(spikes))]
        eng.run(reqs)
        _REF_LOCAL[key] = reqs
    return _REF_LOCAL[key]


def _assert_same_requests(mine, want, what):
    for a, b in zip(mine, want):
        assert a.done and b.done, what
        np.testing.assert_array_equal(a.class_counts,
                                      np.asarray(b.class_counts),
                                      err_msg=f"uid={a.uid} {what}")
        assert a.prediction == b.prediction, (a.uid, what)
        for f in TELEMETRY:
            assert np.array_equal(getattr(a.telemetry, f),
                                  getattr(b.telemetry, f)), (f, a.uid, what)


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("policy", MESH_POLICIES + [
    ExecutionPolicy(backend="mesh", idle_skip=False)], ids=str)
def test_mesh_matches_reference_local_bitwise(net, ref_net, spikes, policy,
                                              D):
    want = _ref_local(ref_net, spikes, policy)
    mine, eng = _serve(net, spikes, policy, devices=["cpu"] * D)
    assert isinstance(eng, MeshEventServeEngine) and eng.D == D
    _assert_same_requests(mine, want, f"{policy} D={D}")
    st = eng.stats
    assert st["mesh_global_windows"] + st["mesh_shard_windows"] \
        == st["windows"] > 0
    if D == 2 and policy.idle_skip:
        # request 3's idle tail rides the global path frozen beside slot 2
        assert st["mesh_shard_windows"] == 0
        assert st["skipped_slot_windows"] > 0


@pytest.mark.parametrize("policy", [
    ExecutionPolicy(backend="mesh"),
    ExecutionPolicy(dtype_policy="int8-native", fusion_policy="per-step",
                    backend="mesh")], ids=str)
def test_mesh_stats_equal_reference_mesh_at_one_shard(net, ref_net, spikes,
                                                      policy):
    jpol = _ref("repro.core.policies")
    jserve = _ref("repro.serve")
    ref = jserve.MeshEventServeEngine(
        ref_net.spec, ref_net.params_for(policy.dtype_policy), n_slots=4,
        window=4, use_pallas=False,
        policy=jpol.ExecutionPolicy(**dataclasses.asdict(policy)))
    assert ref.D == 1
    ref.run([jserve.EventRequest.from_dense(i, spikes[i])
             for i in range(len(spikes))])
    _, mine = _serve(net, spikes, policy, devices=["cpu"])
    st = mine.stats
    # the port's one key beyond the reference's: at D = 1 the devices ran
    # what the counters count
    assert st.pop("device_kernel_launches") == st["kernel_launches"]
    assert st == ref.stats
    assert mine.inter_layer_drops() == ref.inter_layer_drops()
    assert mine.padding_waste() == ref.padding_waste()


# ---------------------------------------------------------------------------
# behaviour with repeated devices
# ---------------------------------------------------------------------------

def test_backend_knob_dispatches_to_mesh_subclass(net):
    spec, params = net
    eng = _mesh(net, 4, 2)
    assert isinstance(eng, MeshEventServeEngine)
    assert eng.policy.backend == "mesh" and eng.D * eng.spd == eng.N == 4
    assert eng.devices == (torch.device("cpu"),) * 2
    assert all(sh.device == torch.device("cpu") and sh.N == 2
               and sh.policy.backend == "local" for sh in eng.shards)
    local = EventServeEngine(spec, params["f32-carrier"], n_slots=2,
                             device="cpu")
    assert type(local) is EventServeEngine
    direct = MeshEventServeEngine(spec, params["f32-carrier"], n_slots=2,
                                  devices=["cpu"])
    assert direct.policy == ExecutionPolicy(backend="mesh")


@pytest.mark.parametrize("case", ["devices_on_local", "device_on_mesh",
                                  "init_with_mesh_policy"])
def test_placement_arguments_are_refused_where_they_do_not_belong(net, case):
    spec, params = net
    mesh = ExecutionPolicy(backend="mesh")
    with pytest.raises(ValueError,
                       match="devices=" if case != "init_with_mesh_policy"
                       else "'local' backend"):
        if case == "devices_on_local":
            EventServeEngine(spec, params["f32-carrier"], n_slots=2,
                             devices=["cpu"])
        elif case == "device_on_mesh":
            EventServeEngine(spec, params["f32-carrier"], n_slots=2,
                             policy=mesh, device="cpu")
        else:
            eng = object.__new__(EventServeEngine)
            EventServeEngine.__init__(eng, spec, params["f32-carrier"],
                                      n_slots=2, policy=mesh, device="cpu")


def test_shards_on_one_device_share_one_copy_of_the_weights(net):
    eng = _mesh(net, 4, 2)
    a, b = eng.shards
    assert all(pa.w is pb.w for pa, pb in zip(a.params, b.params))


@pytest.mark.parametrize("D", [2, 4])
def test_router_balances_least_loaded(net, D):
    eng = _mesh(net, 2 * D, D)
    reqs = [EventRequest.from_dense(i, np.zeros((2, 12, 12, 2), np.float32))
            for i in range(2 * D + 2)]
    for r in reqs[:D]:
        assert eng.try_admit(r)
    assert [sh.n_active for sh in eng.shards] == [1] * D
    assert eng.active.tolist() == [True, False] * D
    # one shard freed: it takes the next request (fewest active, then index)
    eng.evict_slot(2 * (D - 1))
    assert eng.try_admit(reqs[D]) and eng.slot_req[2 * (D - 1)] is reqs[D]
    for r in reqs[D + 1:2 * D + 1]:
        assert eng.try_admit(r)
    assert [sh.n_active for sh in eng.shards] == [2] * D
    assert not eng.try_admit(reqs[-1])


@pytest.mark.parametrize("D", [2, 4])
def test_explicit_slot_routing_and_eviction(net, D):
    eng = _mesh(net, 2 * D, D)
    req = EventRequest.from_dense(7, np.zeros((2, 12, 12, 2), np.float32))
    last = eng.N - 1                     # lives on the last shard
    assert eng.try_admit(req, slot=last)
    assert eng.shards[-1].n_active == 1 and eng.shards[-1].slot_req[1] is req
    assert eng.slot_req[last] is req and eng.n_active == 1
    assert eng.evict_slot(last) is req
    assert eng.n_active == 0 and eng.stats["evicted"] == 1
    assert eng.evict_slot(0) is None
    for bad in (eng.N, -1):
        with pytest.raises(ValueError, match="out of range"):
            eng.try_admit(req, slot=bad)
        with pytest.raises(ValueError, match="out of range"):
            eng.evict_slot(bad)


@pytest.mark.parametrize("D", [2, 4])
def test_idle_shard_launches_nothing(net, spikes, D):
    """With a request pinned to shard 0 only, every window takes the
    per-shard path and the other shards do no kernel work."""
    eng = _mesh(net, 2 * D, D)
    req = EventRequest.from_dense(0, spikes[0])
    assert eng.try_admit(req, slot=0)
    for _ in range(100):
        if req.done:
            break
        eng.step()
    assert req.done
    st = eng.stats
    assert st["mesh_global_windows"] == 0
    assert st["mesh_shard_windows"] == st["windows"] > 0
    assert st["kernel_launches"] == st["device_kernel_launches"] \
        == eng.shards[0].stats["kernel_launches"] > 0
    assert all(sh.stats["kernel_launches"] == sh.stats["step_calls"] == 0
               for sh in eng.shards[1:])
    # the answer is the local engine's
    want, _ = _serve(net, spikes[:1], ExecutionPolicy(), n_slots=1,
                     device="cpu")
    _assert_same_requests([req], want, f"pinned D={D}")


def test_devices_must_divide_slots(net):
    spec, params = net
    with pytest.raises(ValueError, match="divide"):
        EventServeEngine(spec, params["f32-carrier"], n_slots=3,
                         policy=ExecutionPolicy(backend="mesh"),
                         devices=["cpu"] * 2)


@pytest.mark.parametrize("n_slots", [1, 3, 4, 6, 8, 12])
@pytest.mark.parametrize("n_visible", [1, 2, 3, 4, 5, 8, 16])
def test_auto_pick_is_the_largest_divisor_that_fits(n_slots, n_visible):
    d = shard_count(n_slots, n_visible)
    assert n_slots % d == 0 and d <= min(n_slots, n_visible)
    assert d == max(k for k in range(1, min(n_slots, n_visible) + 1)
                    if n_slots % k == 0)


def test_auto_pick_refuses_nonsense():
    for bad in ((0, 2), (4, 0)):
        with pytest.raises(ValueError):
            shard_count(*bad)


def test_slot_mesh_takes_sequences_with_repeats():
    assert slot_mesh(["cpu", torch.device("cpu")]) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="at least 1"):
        slot_mesh([])
    with pytest.raises(ValueError, match="at least 1"):
        slot_mesh(0)


def test_slot_mesh_counts_and_none_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the machine without a CUDA card")
    for devices in (None, 1):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            slot_mesh(devices)


def test_streaming_runtime_policy_crosscheck(net):
    pol = ExecutionPolicy(backend="mesh")
    eng = _mesh(net, 2, 2)
    rt = StreamingRuntime(eng, clock=ManualClock(), policy=pol)
    assert rt.engine is eng
    with pytest.raises(ValueError, match="policy mismatch"):
        StreamingRuntime(eng, clock=ManualClock(), policy=ExecutionPolicy())


def _fresh(req):
    return dataclasses.replace(req, done=False, class_counts=None,
                               prediction=None, telemetry=None)


def _no_sync(fn):
    def strict(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return strict


@pytest.mark.parametrize("policy", MESH_POLICIES, ids=str)
def test_runtime_over_the_mesh_equals_the_synchronous_run(net, spikes,
                                                          policy):
    reqs = _requests(spikes)
    sync = [_fresh(r) for r in reqs]
    _mesh(net, 4, 2, policy).run(sync)
    streamed = [_fresh(r) for r in reqs]
    eng = _mesh(net, 4, 2, policy)
    rt = StreamingRuntime(eng, queue_capacity=8, clock=ManualClock(),
                          policy=policy)
    rep = rt.serve(PoissonLoadGen(streamed, rate_hz=400.0, seed=2))
    assert rep["completed"] == len(reqs)
    _assert_same_requests(streamed, sync, f"runtime {policy}")
    assert eng.stats["completed"] == len(reqs)


def _unequal(spikes):
    """Requests of unequal length (12, 4, 8, 12, 4, 12 timesteps): shards
    fall idle at different windows."""
    return [EventRequest.from_dense(i, spikes[i][:n])
            for i, n in enumerate((12, 4, 8, 12, 4, 12))]


@pytest.mark.parametrize("policy", [
    ExecutionPolicy(backend="mesh"),
    ExecutionPolicy(fusion_policy="per-step", dtype_policy="int8-native",
                    backend="mesh")], ids=str)
def test_one_run_takes_both_dispatch_paths(net, spikes, policy):
    want = _unequal(spikes)
    spec, params = net
    EventServeEngine(spec, params[policy.dtype_policy], n_slots=4, window=4,
                     device="cpu", policy=dataclasses.replace(
                         policy, backend="local")).run(want)
    mine = _unequal(spikes)
    eng = _mesh(net, 4, 2, policy)
    eng.run(mine)
    st = eng.stats
    assert st["mesh_global_windows"] > 0 and st["mesh_shard_windows"] > 0
    assert st["mesh_global_windows"] + st["mesh_shard_windows"] \
        == st["windows"]
    _assert_same_requests(mine, want, f"both paths {policy}")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("fusion", ["fused-window", "fused-network",
                                    "per-step"])
@pytest.mark.parametrize("dtype_policy", ["f32-carrier", "int8-native"])
def test_cuda_mesh_equals_the_cards_local_engine(spikes, dtype_policy,
                                                 fusion):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    spec = tiny_net(n_timesteps=T_STEPS)
    qn = quantize_net(init_snn(np.random.default_rng(0), spec,
                               device="cuda"), spec)
    pol = ExecutionPolicy(dtype_policy=dtype_policy, fusion_policy=fusion)
    want = _unequal(spikes)
    EventServeEngine(qn.spec, qn.params_for(dtype_policy), n_slots=4,
                     window=4, policy=pol).run(want)
    mine = _unequal(spikes)
    mpol = dataclasses.replace(pol, backend="mesh")
    eng = EventServeEngine(qn.spec, qn.params_for(dtype_policy), n_slots=4,
                           window=4, policy=mpol, devices=["cuda:0"] * 2)
    eng._collect_phase = _no_sync(eng._collect_phase)
    eng._launch_phase = _no_sync(eng._launch_phase)
    reset_launch_counts()
    eng.run(mine)
    torch.cuda.synchronize()
    _assert_same_requests(mine, want, f"card mesh {mpol}")
    st = eng.stats
    assert st["mesh_global_windows"] > 0 and st["mesh_shard_windows"] > 0
    # the global path launches on both shards per counted launch
    own = sum(sh.stats["kernel_launches"] for sh in eng.shards)
    assert sum(LAUNCHES.values()) == st["device_kernel_launches"] \
        == own + 2 * (st["kernel_launches"] - own)
