"""The port's core modules against the JAX reference, on the same numpy
inputs: LIF dynamics, event routing, quantisation, events, ingestion,
weights and the analytic hardware model.

Every comparison is exact (``np.array_equal``; -0.0 and +0.0 count
equal, and the port keeps the reference's ``sign·max`` leak, so even the
zeros' signs agree where the two compute the same expression).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import events as jev
from repro.core import lif as jlif
from repro.core import quant as jquant
from repro.core.econv import EConvParams as JParams
from repro.core.layer_program import frame_to_events as jframe_to_events
from repro.core.sne_net import tiny_net as jtiny
from repro.data import events_ds as jds
from repro.serve import telemetry as jtele
from repro.train.snn_loop import load_trained_tiny
from repro_torch.core import engine, events, lif, quant
from repro_torch.core.econv import EConvParams
from repro_torch.core.layer_program import frame_to_events
from repro_torch.core.sne_net import init_snn, tiny_net
from repro_torch.data import events_ds as ds
from repro_torch.serve import telemetry
from repro_torch.weights import load_net, params_from_numpy

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# LIF dynamics, int32 and float32
# ---------------------------------------------------------------------------

def _membranes(dtype, rng):
    if dtype == np.int32:
        return rng.integers(-130, 131, (3, 5, 5, 4)).astype(np.int32)
    v = (rng.standard_normal((3, 5, 5, 4)) * 1.5).astype(np.float32)
    v[0, 0, 0, :2] = [0.0, -0.0]
    return v


@pytest.mark.parametrize("dtype,leak,th,clip", [
    (np.float32, 0.0625, 1.0, None),
    (np.float32, 0.03125, 0.999, 1.5),
    (np.int32, 2.0, 14.0, 127.0),
    (np.int32, 0.0, 5.0, 127.0),
])
@pytest.mark.parametrize("leak_mode", ["toward_zero", "subtract"])
@pytest.mark.parametrize("reset_mode", ["zero", "subtract"])
def test_lif_matches_jax(dtype, leak, th, clip, leak_mode, reset_mode):
    rng = np.random.default_rng(int(leak * 100) + int(th))
    v = _membranes(dtype, rng)
    kw = dict(threshold=th, leak=leak, leak_mode=leak_mode,
              reset_mode=reset_mode, state_clip=clip)
    p, jp = lif.LifParams(**kw), jlif.LifParams(**kw)
    for dt in (1, 3):
        np.testing.assert_array_equal(
            lif.apply_leak(_t(v), leak, dt, leak_mode).numpy(),
            np.asarray(jlif.apply_leak(jnp.asarray(v), leak, dt, leak_mode)))
    got_v, got_s = lif.fire_and_reset(_t(v), p)
    want_v, want_s = jlif.fire_and_reset(jnp.asarray(v), jp)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s.dtype == _t(v).dtype
    if reset_mode == "zero":
        dt = rng.integers(0, 4, (3, 1, 1, 1)).astype(dtype)
        got = lif.idle_decay(_t(v), p, _t(dt)).numpy()
        want = np.asarray(jlif.idle_decay(jnp.asarray(v), jp,
                                          jnp.asarray(dt)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[dt[:, 0, 0, 0] == 0],
                                      v[dt[:, 0, 0, 0] == 0])
    else:
        assert not lif.supports_idle_skip(p)
        with pytest.raises(ValueError):
            lif.idle_decay(_t(v), p, 1)


# ---------------------------------------------------------------------------
# frame_to_events: row-major order, cap clamp, overflow drops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("density,cap", [
    (0.1, 64),        # fits
    (0.5, 16),        # overflows: first 16 row-major sites survive
    (0.0, 8),         # empty frames
    (0.3, 10_000),    # cap past the frame size clamps to it
])
def test_frame_to_events_matches_jax(dtype, density, cap):
    rng = np.random.default_rng(int(density * 10) + cap)
    s = (rng.random((3, 4, 5, 3)) < density).astype(dtype)
    s[1] = 0                                   # one silent slot
    got = frame_to_events(_t(s), cap)
    want = jframe_to_events(jnp.asarray(s), cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.int32
    assert got[1].dtype == _t(s).dtype
    n = (s.reshape(3, -1) != 0).sum(1)
    np.testing.assert_array_equal(got[2].numpy(),
                                  np.maximum(n - min(cap, 60), 0))


# ---------------------------------------------------------------------------
# quantisation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_channel", [True, False])
def test_quantize_net_matches_jax(per_channel):
    spec, jspec = tiny_net(), jtiny()
    params = init_snn(np.random.default_rng(3), spec, device="cpu")
    arrays = [p.w.numpy() for p in params]
    q = quant.quantize_net(params, spec, per_channel=per_channel)
    jq = jquant.quantize_net([JParams(w=jnp.asarray(a)) for a in arrays],
                             jspec, per_channel=per_channel)
    assert q.shared_scales == jq.shared_scales
    for i in range(len(arrays)):
        assert q.codes[i].dtype == torch.int8
        np.testing.assert_array_equal(q.codes[i].numpy(),
                                      np.asarray(jq.codes[i]))
        np.testing.assert_array_equal(q.scales[i].numpy(),
                                      np.asarray(jq.scales[i]))
        np.testing.assert_array_equal(q.packed[i].numpy(),
                                      np.asarray(jq.packed[i]))
        np.testing.assert_array_equal(q.unpacked_codes()[i].numpy(),
                                      q.codes[i].numpy())
        mine, ref = q.spec.layers[i].lif, jq.spec.layers[i].lif
        assert (mine.threshold, mine.leak, mine.state_clip) == \
            (ref.threshold, ref.leak, ref.state_clip)
    for dp in ("f32-carrier", "int8-native"):
        for a, b in zip(q.params_for(dp), jq.params_for(dp)):
            np.testing.assert_array_equal(a.w.numpy(), np.asarray(b.w))
            assert str(a.w.dtype).split(".")[-1] == str(b.w.dtype)


def test_quantize_net_rejects_non_integer_pool_synapses():
    spec = tiny_net()
    params = init_snn(np.random.default_rng(0), spec, device="cpu")
    params[1] = EConvParams(w=params[1].w * 0.25)
    with pytest.raises(ValueError, match="pool"):
        quant.quantize_net(params, spec)


@pytest.mark.parametrize("n", [1, 7, 8, 33])
def test_pack_int4_round_trip_matches_jax(n):
    q = np.random.default_rng(n).integers(-8, 8, n).astype(np.int8)
    packed = quant.pack_int4(_t(q))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jquant.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(quant.unpack_int4(packed, n).numpy(), q)


# ---------------------------------------------------------------------------
# events, ingestion, weights, telemetry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [64, 5])
def test_dense_to_events_matches_jax(capacity):
    s = (np.random.default_rng(0).random((3, 4, 4, 2)) < 0.2).astype(
        np.float32)
    got = events.dense_to_events(_t(s), capacity)
    want = jev.dense_to_events(jnp.asarray(s), capacity)
    for f in events.EventStream._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert events.overflow_count(_t(s), capacity) == int(
        jev.overflow_count(jnp.asarray(s), capacity))


def test_recording_ingestion_matches_jax():
    rec = ds.synthesize_recording(seed=4, width=40, height=30,
                                  rate_hz=120_000.0)
    jrec = jds.synthesize_recording(seed=4, width=40, height=30,
                                    rate_hz=120_000.0)
    for f in ("t", "x", "y", "p"):
        np.testing.assert_array_equal(getattr(rec, f), getattr(jrec, f))
    for shape in ((12, 12, 2), (8, 10, 1)):
        got = ds.segment_recording(rec, shape, 16, 1000)
        want = jds.segment_recording(jrec, shape, 16, 1000)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for f in events.EventStream._fields:
                np.testing.assert_array_equal(getattr(a.stream, f).numpy(),
                                              np.asarray(getattr(b.stream, f)))
    for name in ("tiny_gesture.npz", "tiny_gesture.aedat"):
        a = ds.load_recording(ds.sample_recording_path(name))
        b = jds.load_recording(jds.sample_recording_path(name))
        for f in ("t", "x", "y", "p"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.width, a.height, a.label) == (b.width, b.height, b.label)


def test_load_net_matches_the_reference_loader():
    jspec, jparams, jmeta = load_trained_tiny()
    params, meta = load_net(ds.sample_recording_path(
        "tiny_gesture_trained.npz"), tiny_net(), device="cpu")
    for p, jp in zip(params, jparams):
        np.testing.assert_array_equal(p.w.numpy(), np.asarray(jp.w))
    assert sorted(meta) == sorted(jmeta)
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy([np.zeros((2, 2))] * 3, tiny_net(), device="cpu")


def test_telemetry_and_hardware_model_match_jax():
    kw = dict(uid=3, n_timesteps=16, n_windows=4,
              per_layer_events=[120.0, 40.0, 7.0],
              per_layer_sops=[120.0 * 54, 40.0, 7.0 * 4], input_sites=700,
              input_dropped=2, inter_layer_dropped=[0.0, 1.0, 0.0],
              wall_time_s=0.5, n_parallel_slices=2, n_dense_timesteps=12,
              n_skipped_windows=1)
    for cfg, jcfg in ((engine.SneConfig(), jengine.SneConfig()),
                      (engine.SneConfig(cycles_per_boundary=64),
                       jengine.SneConfig(cycles_per_boundary=64))):
        a = telemetry.request_telemetry(cfg, **kw)
        b = jtele.request_telemetry(jcfg, **kw)
        assert a.__dict__ == b.__dict__
        assert telemetry.summarize([a, a]) == jtele.summarize([b, b])
        assert engine.inference_time_s(cfg, 167.0, 3, [120.0, 40.0, 7.0]) \
            == jengine.inference_time_s(jcfg, 167.0, 3, [120.0, 40.0, 7.0])
