"""The port's serving engine end to end, against the JAX reference.

* the trained tiny checkpoint, served under both dtype policies, per-step,
  fused-window (tile sparsity on and off) and fused-network, equals the
  committed golden ``tests/golden/tiny_gesture_trained_serve.npz`` key for
  key;
* the port's engine equals the live JAX engine (``use_pallas=False``) on
  synthesized 12x12 recordings, idle skip on and off, under the same
  lowerings: per-request class counts and telemetry, engine statistics
  (layer-0 tile occupancy and kernel launches included: 1 per step call
  under fused-network), padding and drop accounting;
* the full-width Fig. 6 slice (``dvs_gesture_net(n_timesteps=8)``, two
  requests at 2 MHz on two slots) equals the JAX engine under both dtype
  policies.

Every comparison is exact; only the host wall-clock field of the
telemetry is left out.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.econv import EConvParams as JParams
from repro.core.lif import LifParams as JLif
from repro.core.policies import ExecutionPolicy as JPolicy
from repro.core.sne_net import dvs_gesture_net as jdvs
from repro.core.sne_net import tiny_net as jtiny
from repro.data import events_ds as jds
from repro.serve import EventServeEngine as JEngine
from repro_torch.core.econv import EConvParams
from repro_torch.core.policies import ExecutionPolicy
from repro_torch.core.quant import quantize_net
from repro_torch.core.sne_net import dvs_gesture_net, init_snn, tiny_net
from repro_torch.data import events_ds as ds
from repro_torch.serve import EventServeEngine
from repro_torch.weights import load_net

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "tiny_gesture_trained_serve.npz")
WINDOW_US = 1000
POLICIES = ["f32-carrier", "int8-native"]
# (fusion policy, tile sparsity): the per-step oracle, the default
# fused-window lowering with its bitmaps on and off, and fused-network
FUSIONS = [("per-step", True), ("fused-window", True), ("fused-window", False),
           ("fused-network", True)]


def _results(reqs):
    tele = [r.telemetry for r in reqs]
    out = {
        "class_counts": np.stack([r.class_counts for r in reqs]),
        "predictions": np.asarray([r.prediction for r in reqs], np.int64),
        "per_layer_events": np.stack([np.asarray(t.per_layer_events)
                                      for t in tele]),
        "inter_layer_dropped": np.stack([np.asarray(t.inter_layer_dropped)
                                         for t in tele]),
        "input_dropped": np.asarray([t.input_dropped for t in tele],
                                    np.int64),
    }
    for f in dataclasses.fields(tele[0]):
        if f.name not in out and f.name != "wall_time_s":
            out["tele_" + f.name] = np.asarray([getattr(t, f.name)
                                                for t in tele])
    return out


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("fusion,tile_sparsity", FUSIONS)
@pytest.mark.parametrize("dtype_policy", POLICIES)
def test_trained_checkpoint_equals_golden(dtype_policy, fusion,
                                          tile_sparsity):
    spec = tiny_net()
    params, _ = load_net(ds.sample_recording_path("tiny_gesture_trained.npz"),
                         spec, device="cpu")
    qn = quantize_net(params, spec, per_channel=False)
    reqs = ds.segment_recording(ds.load_recording(ds.sample_recording_path()),
                                qn.spec.in_shape, qn.spec.n_timesteps,
                                WINDOW_US)
    eng = EventServeEngine(qn.spec, qn.params_for(dtype_policy), n_slots=2,
                           window=4, device="cpu", policy=ExecutionPolicy(
                               dtype_policy=dtype_policy,
                               fusion_policy=fusion,
                               tile_sparsity=tile_sparsity))
    eng.run(reqs)
    res = _results(reqs)
    gold = np.load(GOLDEN)
    for k in gold.files:
        np.testing.assert_array_equal(res[k], gold[k], err_msg=k)


def _both_engines(spec, jspec, arrays, dtype_policy, recs, T, n_slots,
                  idle_skip=True, step_capacities=None, fusion="per-step",
                  tile_sparsity=True):
    """Serve the same recordings on the port and on the JAX engine.

    The port quantizes the numpy weights (its parity with the reference's
    `quantize_net` is `test_torch_core`'s); both engines then get the same
    integer codes and the same integer LIF plan.
    """
    q = quantize_net([EConvParams(w=torch.from_numpy(a)) for a in arrays],
                     spec)
    jspec = dataclasses.replace(jspec, layers=tuple(
        dataclasses.replace(jl, lif=JLif(**dataclasses.asdict(l.lif)))
        for jl, l in zip(jspec.layers, q.spec.layers)))
    params = q.params_for(dtype_policy)
    jparams = [JParams(w=jnp.asarray(p.w.numpy())) for p in params]
    pol = ExecutionPolicy(dtype_policy=dtype_policy, fusion_policy=fusion,
                          idle_skip=idle_skip, tile_sparsity=tile_sparsity)
    out = []
    for eng, mod, in_shape in (
            (EventServeEngine(q.spec, params, n_slots, window=4,
                              step_capacities=step_capacities, device="cpu",
                              policy=pol), ds, q.spec.in_shape),
            (JEngine(jspec, jparams, n_slots, window=4,
                     step_capacities=step_capacities, use_pallas=False,
                     policy=JPolicy(**dataclasses.asdict(pol))), jds,
             jspec.in_shape)):
        reqs = []
        for i, kw in enumerate(recs):
            rec = mod.synthesize_recording(**kw)
            reqs += mod.segment_recording(rec, in_shape, T, WINDOW_US,
                                          uid_base=100 * i)
        eng.run(reqs)
        out.append((_results(reqs), eng))
    return out


# without idle skip only the oracle lowering: the fused lowering's full
# batch is held by the golden test and test_window_step_matches_jax
@pytest.mark.parametrize("idle_skip,fusion,tile_sparsity", [
    (True, *f) for f in FUSIONS] + [(False, *FUSIONS[0])])
@pytest.mark.parametrize("dtype_policy", POLICIES)
def test_engine_matches_live_jax_engine(dtype_policy, idle_skip, fusion,
                                        tile_sparsity):
    spec, jspec = tiny_net(), jtiny()
    arrays = [p.w.numpy() for p in init_snn(np.random.default_rng(21), spec,
                                            device="cpu")]
    # a busy recording beside a sparse one: idle windows, slot compaction;
    # small buckets: collector and inter-layer overflow drops (and few
    # distinct launch shapes for the reference to compile)
    recs = [dict(seed=1, rate_hz=40_000.0, label=1, duration_us=32_000),
            dict(seed=2, rate_hz=400.0, label=3, duration_us=48_000),
            dict(seed=3, rate_hz=90_000.0, label=0, duration_us=16_000)]
    (mine, eng), (ref, jeng) = _both_engines(spec, jspec, arrays,
                                             dtype_policy, recs, 16, 3,
                                             idle_skip, (16, 96, 24),
                                             fusion, tile_sparsity)
    _assert_same(mine, ref)
    assert eng.stats == jeng.stats
    assert eng.padding_waste() == jeng.padding_waste()
    assert eng.inter_layer_drops() == jeng.inter_layer_drops()
    assert eng.stats["collector_dropped"] > 0
    assert eng.inter_layer_drops()["inter_layer_dropped_total"] > 0
    if idle_skip:
        assert eng.stats["skipped_slot_windows"] > 0
    assert 0 < eng.stats["hot_tiles"] < eng.stats["total_tiles"]
    per_call = {"per-step": 4 * 3, "fused-window": 3, "fused-network": 1}
    assert eng.stats["kernel_launches"] == (per_call[fusion]
                                            * eng.stats["step_calls"])


@pytest.mark.parametrize("dtype_policy", POLICIES)
def test_full_width_slice_matches_jax(dtype_policy):
    T = 8
    spec, jspec = dvs_gesture_net(n_timesteps=T), jdvs(n_timesteps=T)
    arrays = [p.w.numpy() for p in init_snn(np.random.default_rng(0), spec,
                                            device="cpu")]
    recs = [dict(seed=s, width=128, height=128, duration_us=T * WINDOW_US,
                 rate_hz=2e6, label=s) for s in (5, 6)]
    (mine, eng), (ref, jeng) = _both_engines(spec, jspec, arrays,
                                             dtype_policy, recs, T, 2)
    _assert_same(mine, ref)
    assert eng.stats == jeng.stats
    # the Fig. 6 traffic is real: every layer consumed events
    assert (mine["per_layer_events"] > 0).all()
