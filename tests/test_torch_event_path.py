"""The port's single-stream event path and event format against the JAX
reference.

The same numpy inputs go through the reference and the port, on the CPU.
The reference runs its pure-jnp path (``layer_event_forward`` has no
Pallas; ``event_forward`` and ``event_apply`` are jitted once per shape,
which is the same scan); the port's scatters reach their plain versions.
Every comparison is exact (``np.array_equal``, which counts -0.0 equal to
+0.0: the port's scatters skip a gated-off event where the scan adds
``w·0``, which can flip the sign of a zero and nothing else):

* ``event_forward`` on a conv, a pool and an fc layer with unquantized
  float weights (the order of the adds shows), on idle gaps, and with an
  OP_RST mid-stream: the output stream, the membrane and every
  ``EConvStats`` counter; SOPs = events x K^2 x Co;
* the segmented executor against the per-event plain scan
  (``_layer_event_forward_plain``) and JAX on adversarial streams:
  unsorted, invalid events mid-stream, a stream without and with tail
  padding, a first event after t = 0, an all-padding stream, two RSTs in
  one timestep, a "subtract" leak, an overflowing output buffer; and an
  empty (zero-capacity) stream against the plain scan;
* ``event_apply`` / ``event_predict`` on ``tiny_net`` and on the reduced
  Fig. 6 net (16x16, T = 8) under both dtype policies; the class counts
  equal the port's own engine on the CPU;
* ``quantize_snn``, ``quantize_state``, ``weight_bytes``; the packed event
  word, ``sort_stream``, ``concatenate_streams``, ``activity`` and the
  capacity rules; ``save_events_npz`` / ``save_events_aedat`` read back by
  the other package's loaders; soft reset, other devices and the engine's
  refusal of OP_RST streams.

The ``gpu`` tests (skipped without a card) hold the three N = 1 scatter
faces against their plain versions on the card's gate patterns in every
dtype pairing, and ``event_apply`` on the card against the CPU.  The
card's machine has no JAX, so this file imports the reference lazily:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_event_path.py
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import econv, events as ev, layer_program as lp
from repro_torch.core.econv import EConvParams, EConvSpec
from repro_torch.core.lif import LifParams
from repro_torch.core.quant import (QuantizedLayer, dequantize_state,
                                    quantize_net, quantize_state)
from repro_torch.core.sne_net import (default_capacities, dvs_gesture_net,
                                      event_apply, event_predict,
                                      init_econv_numpy, init_snn,
                                      quantize_snn, tiny_net)
from repro_torch.data import events_ds as ds
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.event_conv import event_conv, event_conv_ref
from repro_torch.kernels.event_fc import event_fc, event_fc_ref
from repro_torch.kernels.event_pool import event_pool, event_pool_ref
from repro_torch.serve import EventRequest, EventServeEngine
from test_torch_kernels import (GATE_PATTERNS, PAIRINGS, _arrays,
                                _gate_pattern, _torch_out, fc_walk_case,
                                pool_walk_case)

torch.set_num_threads(1)


class _Lazy:
    """A module of the reference, imported on first use: the card's
    machine has no JAX, and the gpu tests never touch one."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


jax, jnp = _Lazy("jax"), _Lazy("jax.numpy")
jev, jecv = _Lazy("repro.core.events"), _Lazy("repro.core.econv")
jlif, jsn = _Lazy("repro.core.lif"), _Lazy("repro.core.sne_net")
jquant, jlp = _Lazy("repro.core.quant"), _Lazy("repro.core.layer_program")
jds = _Lazy("repro.data.events_ds")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _jlayer(l):
    return jecv.EConvSpec(l.kind, l.in_shape, l.out_channels,
                          kernel=l.kernel, stride=l.stride,
                          padding=l.padding,
                          lif=jlif.LifParams(**dataclasses.asdict(l.lif)))


def _jspec(spec):
    return jsn.SNNSpec(layers=tuple(_jlayer(l) for l in spec.layers),
                       n_timesteps=spec.n_timesteps,
                       n_classes=spec.n_classes)


def _jstream(s):
    return jev.EventStream(*(jnp.asarray(_np(f)) for f in s))


def _stream(t, x, y, c, op, valid):
    return ev.EventStream(*(_t(np.asarray(a, dt)) for a, dt in zip(
        (t, x, y, c, op, valid), [np.int32] * 5 + [bool])))


@functools.lru_cache(maxsize=None)
def _jax_event_forward():
    # jitted once per (spec, shapes, capacity, T, policy): the same scan
    return jax.jit(jecv.event_forward, static_argnums=(1, 3, 4, 5))


@functools.lru_cache(maxsize=None)
def _jax_event_apply():
    return jax.jit(jsn.event_apply, static_argnums=(1, 3, 4))


def _forward_all(spec, w, stream, cap, T, dtype_policy="f32-carrier"):
    """The port's segmented executor, its plain scan and JAX, on one layer."""
    params = EConvParams(w=_t(w))
    got = econv.event_forward(params, spec, stream, cap, T,
                              dtype_policy=dtype_policy, device="cpu")
    plain = lp._layer_event_forward_plain(
        lp.layer_op(spec, dtype_policy=dtype_policy), params, stream, cap, T)
    want = _jax_event_forward()(jecv.EConvParams(w=jnp.asarray(w)),
                                _jlayer(spec), _jstream(stream), cap, T,
                                dtype_policy)
    return got, plain, want


def _assert_same_forward(got, want, what=""):
    (s1, v1, st1), (s2, v2, st2) = got, want
    for f, a, b in zip(s1._fields, s1, s2):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=f"{what} {f}")
    assert str(v1.dtype).split(".")[-1] == str(v2.dtype).split(".")[-1]
    np.testing.assert_array_equal(_np(v1), _np(v2), err_msg=what)
    _assert_same_stats(st1, st2, what)


def _assert_same_stats(a, b, what=""):
    assert [int(x) for x in a] == [int(x) for x in b], (what, a, b)


# ---------------------------------------------------------------------------
# one layer: event_forward (the reference's test_equivalence cases)
# ---------------------------------------------------------------------------

LAYERS = {
    "conv": (EConvSpec("conv", (8, 8, 2), 4, kernel=3, padding=1,
                       lif=LifParams(threshold=0.8, leak=0.05)),
             (5, 8, 8, 2), 0.2),
    "pool": (EConvSpec("pool", (8, 8, 3), 3, kernel=2, stride=2,
                       lif=LifParams(threshold=0.999, leak=0.0)),
             (4, 8, 8, 3), 0.2),
    "fc": (EConvSpec("fc", (4, 4, 2), 6,
                     lif=LifParams(threshold=1.2, leak=0.1)),
           (6, 4, 4, 2), 0.25),
}


@pytest.mark.parametrize("kind", ["conv", "pool", "fc"])
def test_event_forward_matches_jax(kind):
    spec, shape, p = LAYERS[kind]
    rng = np.random.default_rng(3)
    spikes = (rng.random(shape) < p).astype(np.float32)
    w = init_econv_numpy(rng, spec)
    stream = ev.dense_to_events(_t(spikes), spikes.size)
    T = shape[0]
    cap = T * int(np.prod(spec.out_shape))
    got, plain, want = _forward_all(spec, w, stream, cap, T)
    _assert_same_forward(got, want, kind)
    _assert_same_forward(got, plain, kind)
    assert int(got[2].n_out_events) > 0 and int(got[2].n_boundaries) == T - 1


def test_idle_timesteps_cost_nothing():
    spec = EConvSpec("conv", (6, 6, 1), 2, kernel=3, padding=1,
                     lif=LifParams(threshold=0.7, leak=0.03))
    T = 50
    spikes = np.zeros((T, 6, 6, 1), np.float32)
    spikes[0, 2, 2, 0] = spikes[T - 1, 3, 3, 0] = 1.0
    w = init_econv_numpy(np.random.default_rng(4), spec)
    stream = ev.dense_to_events(_t(spikes), spikes.size)
    got, plain, want = _forward_all(spec, w, stream, T * 72, T)
    _assert_same_forward(got, want)
    _assert_same_forward(got, plain)
    assert int(got[2].n_update_events) == 2
    assert int(got[2].n_boundaries) <= 3        # 2 boundaries crossed of 49


def test_sops_are_events_times_k2_co():
    spec = LAYERS["conv"][0]
    w = init_econv_numpy(np.random.default_rng(5), spec)
    for p in (0.05, 0.1, 0.2):
        spikes = (np.random.default_rng(42).random((5, 8, 8, 2)) < p).astype(
            np.float32)
        stream = ev.dense_to_events(_t(spikes), spikes.size)
        _, _, st = econv.event_forward(EConvParams(w=_t(w)), spec, stream,
                                       640, 5, device="cpu")
        n_ev = int(spikes.sum())
        assert int(st.n_update_events) == n_ev
        assert int(st.n_sops) == n_ev * 9 * 4


def test_rst_mid_stream_resets_state():
    spec = EConvSpec("conv", (6, 6, 1), 2, kernel=3, padding=1,
                     lif=LifParams(threshold=10.0, leak=0.0))
    spikes = np.zeros((3, 6, 6, 1), np.float32)
    spikes[0, 2, 2, 0] = 1.0
    stream = ev.concatenate_streams(
        ev.dense_to_events(_t(spikes), 16),
        _stream([1], [0], [0], [0], [ev.OP_RST], [True]))
    w = init_econv_numpy(np.random.default_rng(6), spec)
    got, plain, want = _forward_all(spec, w, stream, 128, 3)
    _assert_same_forward(got, want)
    _assert_same_forward(got, plain)
    assert not got[1].any()


# ---------------------------------------------------------------------------
# adversarial streams: segmented executor == plain scan == JAX
# ---------------------------------------------------------------------------

ADV_T, ADV_E = 6, 48
ADV_SPEC = EConvSpec("conv", (6, 6, 2), 3, kernel=3, padding=1,
                     lif=LifParams(threshold=0.9, leak=0.1))


def _adversarial(case, rng):
    """``(stream fields, spec, out_capacity)`` of one adversarial case."""
    T, E = ADV_T, ADV_E
    t = np.sort(rng.integers(0, T, E))
    x, y = rng.integers(0, 6, E), rng.integers(0, 6, E)
    c = rng.integers(0, 2, E)
    op = np.full(E, ev.OP_UPDATE)
    valid = np.ones(E, bool)
    spec, cap = ADV_SPEC, T * 6 * 6 * 3
    if case == "unsorted":
        order = rng.permutation(E)
        t, x, y, c = t[order], x[order], y[order], c[order]
    elif case == "invalid_mid":
        bad = rng.choice(np.arange(4, E - 4), 10, replace=False)
        valid[bad] = False
        t[bad] = rng.integers(0, T + 3, 10)
    elif case in ("no_padding", "padding"):
        t = np.sort(rng.integers(0, T - 2, E))     # the last event before T-1
        valid[40:] = False
        t[40:] = T
        if case == "no_padding":
            t, x, y, c, op, valid = (a[:40] for a in (t, x, y, c, op, valid))
    elif case == "late_start":
        t = np.sort(rng.integers(2, T, E))
    elif case == "all_padding":
        valid[:] = False
        t[:] = T
    elif case == "two_rst":
        # one timestep: updates before, between and after two RSTs
        t[20:28] = t[20]
        op[22] = op[25] = ev.OP_RST
    elif case == "subtract":
        spec = dataclasses.replace(ADV_SPEC, lif=LifParams(
            threshold=0.9, leak=0.1, leak_mode="subtract"))
    elif case == "overflow":
        cap = 20
    return (t, x, y, c, op, valid), spec, cap


@pytest.mark.parametrize("case", ["unsorted", "invalid_mid", "no_padding",
                                  "padding", "late_start", "all_padding",
                                  "two_rst", "subtract", "overflow"])
def test_adversarial_stream_matches_plain_and_jax(case):
    rng = np.random.default_rng(7)
    fields, spec, cap = _adversarial(case, rng)
    w = init_econv_numpy(np.random.default_rng(8), spec)
    got, plain, want = _forward_all(spec, w, _stream(*fields), cap, ADV_T)
    _assert_same_forward(got, want, case)
    _assert_same_forward(got, plain, case)
    st = got[2]
    if case == "overflow":
        assert int(st.n_dropped) == int(st.n_out_events) - cap > 0
    if case == "two_rst":
        assert (fields[4] == ev.OP_RST).sum() == 2
    if case == "subtract":
        assert (_np(got[1]) < 0).any()      # the first leak of a zero slab
    if case == "padding":
        # tail padding clamps to T-1: one more boundary than without it
        short, _, _ = _forward_all(spec, w, _stream(
            *(a[:40] for a in fields)), cap, ADV_T)
        assert int(st.n_boundaries) == int(short[2].n_boundaries) + 1


def test_zero_capacity_stream_matches_plain():
    spec = ADV_SPEC
    params = EConvParams(w=_t(init_econv_numpy(np.random.default_rng(9),
                                               spec)))
    empty = _stream(*([[]] * 6))
    got = econv.event_forward(params, spec, empty, 16, ADV_T, device="cpu")
    _assert_same_forward(got, lp._layer_event_forward_plain(
        lp.layer_op(spec), params, empty, 16, ADV_T))
    assert int(got[2].n_out_events) == 0 and empty.capacity == 0


def test_soft_reset_is_refused():
    spec = dataclasses.replace(ADV_SPEC, lif=LifParams(reset_mode="subtract"))
    w = _t(init_econv_numpy(np.random.default_rng(9), spec))
    with pytest.raises(ValueError, match="reset_mode='zero'"):
        econv.event_forward(EConvParams(w=w), spec, _stream(*([[]] * 6)),
                            16, ADV_T, device="cpu")


def test_a_stream_or_weights_elsewhere_are_refused():
    spec = tiny_net()
    params = init_snn(np.random.default_rng(0), spec, device="cpu")
    stream = ev.dense_to_events(torch.zeros((16, 12, 12, 2)), 8)
    meta = [EConvParams(w=torch.zeros(p.w.shape, device="meta"))
            for p in params]
    with pytest.raises(ValueError, match="layer 0 weights lies on meta"):
        event_apply(meta, spec, stream, default_capacities(spec),
                    device="cpu")
    with pytest.raises(ValueError, match="stream field t lies on meta"):
        econv.event_forward(params[0], spec.layers[0], ev.EventStream(
            *(f.to("meta") for f in stream)), 16, 16, device="cpu")


# ---------------------------------------------------------------------------
# whole networks: event_apply / event_predict
# ---------------------------------------------------------------------------

NETS = {"tiny_net": tiny_net,
        "fig6_16x16": lambda: dvs_gesture_net(n_timesteps=8, height=16,
                                              width=16)}


def _net_case(name, dtype_policy, seed=11):
    """``(spec, params, stream)``: float weights on the carrier (the order
    of the adds shows), the int4 lowering's codes under int8-native; 8%
    input spikes."""
    spec = NETS[name]()
    params = init_snn(np.random.default_rng(0), spec, device="cpu")
    if dtype_policy == "int8-native":
        q = quantize_net(params, spec)
        spec, params = q.spec, q.params_for(dtype_policy)
    rng = np.random.default_rng(seed)
    spikes = (rng.random((spec.n_timesteps,) + spec.in_shape) < 0.08
              ).astype(np.float32)
    return spec, params, ev.dense_to_events(_t(spikes), int(spikes.sum()) + 8)


@pytest.mark.parametrize("dtype_policy", ["f32-carrier", "int8-native"])
@pytest.mark.parametrize("name", list(NETS))
def test_event_apply_and_predict_match_jax(name, dtype_policy):
    spec, params, stream = _net_case(name, dtype_policy)
    caps = default_capacities(spec, activity=0.2, slack=6.0)
    out, stats = event_apply(params, spec, stream, caps,
                             dtype_policy=dtype_policy, device="cpu")
    jout, jstats = _jax_event_apply()(
        [jecv.EConvParams(w=jnp.asarray(_np(p.w))) for p in params],
        _jspec(spec), _jstream(stream), tuple(caps), dtype_policy)
    for f, a, b in zip(out._fields, out, jout):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=f)
    for a, b in zip(stats.per_layer, jstats.per_layer):
        _assert_same_stats(a, b)
    assert int(stats.total_events) == int(jstats.total_events)
    assert int(stats.total_sops) == int(jstats.total_sops)
    cls, counts, _ = event_predict(params, spec, stream, caps,
                                   dtype_policy=dtype_policy, device="cpu")
    c = np.where(_np(jout.valid), _np(jout.c), spec.n_classes)
    want = np.bincount(c, minlength=spec.n_classes + 1)[:-1]
    np.testing.assert_array_equal(_np(counts), want.astype(np.float32))
    assert int(cls) == int(np.argmax(want))
    assert sum(int(s.n_out_events) for s in stats.per_layer) > 0


@pytest.mark.parametrize("name", list(NETS))
def test_event_predict_equals_the_engine(name):
    # the two executors of one program (reference test_layer_program.py:211),
    # bitwise on the integer-domain net, under both dtype policies
    spec, params, stream = _net_case(name, "f32-carrier")
    q = quantize_net(params, spec)
    spikes = ev.events_to_dense(stream, (q.spec.n_timesteps,)
                                + q.spec.in_shape)
    caps = default_capacities(q.spec, activity=0.2, slack=6.0)
    eng = EventServeEngine(q.spec, q.params_for("f32-carrier"), n_slots=1,
                           device="cpu")
    req = EventRequest.from_dense(0, spikes)
    eng.run([req])
    for dp in ("f32-carrier", "int8-native"):
        _, counts, stats = event_predict(q.params_for(dp), q.spec, stream,
                                         caps, dtype_policy=dp, device="cpu")
        assert not any(int(s.n_dropped) for s in stats.per_layer)
        np.testing.assert_array_equal(_np(counts), np.asarray(
            req.class_counts, np.float32))
        assert req.telemetry.per_layer_events[0] == float(
            stats.per_layer[0].n_update_events)


def test_engine_refuses_rst_streams_and_event_apply_serves_them():
    spec = tiny_net()
    q = quantize_net(init_snn(np.random.default_rng(0), spec, device="cpu"),
                     spec)
    spikes = (np.random.default_rng(12).random((16, 12, 12, 2)) < 0.1
              ).astype(np.float32)
    stream = ev.concatenate_streams(
        ev.dense_to_events(_t(spikes), int(spikes.sum())),
        _stream([5, 9], [0, 0], [0, 0], [0, 0], [ev.OP_RST, ev.OP_RST],
                [True, True]))
    eng = EventServeEngine(q.spec, q.params_for("f32-carrier"), n_slots=1,
                           device="cpu")
    with pytest.raises(ValueError, match=r"non-UPDATE events .* run such "
                       r"streams through repro_torch\.core\.sne_net\."
                       r"event_apply"):
        eng.run([EventRequest(uid=0, stream=stream, n_timesteps=16)])
    caps = default_capacities(q.spec, activity=0.5, slack=4.0)
    params = q.params_for("f32-carrier")
    out, stats = event_apply(params, q.spec, stream, caps, device="cpu")
    # the same chain through the per-event plain scan
    prog = lp.compile_program(q.spec, device="cpu")
    s = stream
    for op, p, cap, st in zip(prog.ops, params, caps, stats.per_layer):
        s, _, pst = lp._layer_event_forward_plain(op, p, s, cap, 16)
        _assert_same_stats(st, pst)
    for a, b in zip(out, s):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# quantisation, the event word, stream helpers, capacities, recordings
# ---------------------------------------------------------------------------

def test_quantize_snn_state_and_weight_bytes_match_jax():
    spec = tiny_net()
    params = init_snn(np.random.default_rng(1), spec, device="cpu")
    jparams = [jecv.EConvParams(w=jnp.asarray(_np(p.w))) for p in params]
    qp, qspec = quantize_snn(params, spec)
    jqp, jqspec = jsn.quantize_snn(jparams, _jspec(spec))
    for a, b, l, jl in zip(qp, jqp, qspec.layers, jqspec.layers):
        assert a.w.dtype == torch.float32
        np.testing.assert_array_equal(_np(a.w), _np(b.w))
        assert dataclasses.asdict(l.lif) == dataclasses.asdict(jl.lif)
    q = QuantizedLayer.from_float(spec.layers[0], params[0])
    jq = jquant.QuantizedLayer.from_float(_jspec(spec).layers[0], jparams[0])
    assert q.w_scale_max == jq.w_scale_max
    assert quantize_net(params, spec).weight_bytes() == jquant.quantize_net(
        jparams, _jspec(spec)).weight_bytes()
    v = np.random.default_rng(2).standard_normal(300).astype(np.float32) * 9
    v[:3] = [0.5, -2.5, 1e4]                      # ties to even, saturation
    got = quantize_state(_t(v), 0.07)
    want = jquant.quantize_state(jnp.asarray(v), 0.07)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(dequantize_state(got, 0.07)),
                                  _np(jquant.dequantize_state(want, 0.07)))


def _random_stream(rng, E, T=4000):
    return (rng.integers(0, T, E), rng.integers(0, 128, E),
            rng.integers(0, 128, E), rng.integers(0, 16, E),
            rng.integers(0, 3, E), rng.random(E) < 0.8)


def test_packed_event_words_match_jax():
    rng = np.random.default_rng(13)
    t0, x, y, c, op, valid = _random_stream(rng, 200)
    t = np.where(valid, t0, 9000)         # padding past the 12-bit budget
    s = _stream(t, x, y, c, op, valid)
    words = ev.pack_events(s)
    assert words.dtype == torch.uint32
    want = np.asarray(jev.pack_events(_jstream(s)))
    assert want.dtype == np.uint32
    np.testing.assert_array_equal(words.numpy(), want)
    back = ev.unpack_events(words, s.valid)
    for f in ev.EventStream._fields:
        np.testing.assert_array_equal(_np(getattr(back, f))[valid],
                                      _np(getattr(s, f))[valid])
    assert s.capacity == 200 and int(s.count()) == valid.sum()
    assert s.count().dtype == torch.int32
    # out of range: the check raises, unchecked packing masks as JAX does
    bad = _stream(np.where(np.arange(200) == 7, 5000, t0), x,
                  np.where(np.arange(200) == 9, -1, y), c, op,
                  np.ones(200, bool))
    assert int(ev.pack_violations(bad)) == int(
        jev.pack_violations(_jstream(bad))) == 2
    with pytest.raises(ValueError, match="field 't' of a valid event"):
        ev.pack_events(bad)
    np.testing.assert_array_equal(
        ev.pack_events(bad, check=False).numpy(),
        np.asarray(jev.pack_events(_jstream(bad), check=False)))
    fmt = ev.EventFormat(op_bits=2, t_bits=14, c_bits=2, x_bits=7, y_bits=7)
    np.testing.assert_array_equal(
        ev.pack_events(s, fmt, check=False).numpy(),
        np.asarray(jev.pack_events(_jstream(s), jev.EventFormat(
            op_bits=2, t_bits=14, c_bits=2, x_bits=7, y_bits=7),
            check=False)))
    with pytest.raises(ValueError, match="bits > 32"):
        ev.EventFormat(t_bits=20)


def test_sort_concatenate_activity_and_capacities_match_jax():
    rng = np.random.default_rng(14)
    a = _stream(*_random_stream(rng, 50, T=6))
    b = _stream(*_random_stream(rng, 30, T=6))
    for got, want in ((ev.sort_stream(a), jev.sort_stream(_jstream(a))),
                      (ev.concatenate_streams(a, b), jev.concatenate_streams(
                          _jstream(a), _jstream(b)))):
        for f, x, y in zip(got._fields, got, want):
            np.testing.assert_array_equal(_np(x), _np(y), err_msg=f)
    spikes = (rng.random((7, 9, 11, 3)) < 0.13).astype(np.float32)
    assert ev.activity(_t(spikes)).dtype == torch.float32
    assert float(ev.activity(_t(spikes))) == float(
        jev.activity(jnp.asarray(spikes)))
    spec = dvs_gesture_net()
    jspec = _jspec(spec)
    for kw in ({}, {"activity": 1.0, "slack": 1.0},
               {"activity": 0.02, "slack": 3.0}):
        assert default_capacities(spec, **kw) == jsn.default_capacities(
            jspec, **kw)
        assert lp.default_stream_capacities(spec, **kw) == \
            jlp.default_stream_capacities(jspec, **kw)
    for kw in ({}, {"activity": 0.1, "slack": 2.0, "align": 16}):
        assert lp.default_step_capacities(spec, **kw) == \
            jlp.default_step_capacities(jspec, **kw)
        assert lp.layer_step_capacity(spec.layers[1], **kw) == \
            jlp.layer_step_capacity(jspec.layers[1], **kw)


@pytest.mark.parametrize("fmt", ["npz", "aedat"])
def test_recordings_round_trip_between_the_packages(fmt, tmp_path):
    rec = ds.synthesize_recording(seed=3, duration_us=4000, rate_hz=2e5,
                                  label=5)
    if fmt == "aedat":
        # past 2^31 us: packets split where the 31-bit timestamp wraps
        rec.t = rec.t + (1 << 31) - 2000
        rec.label = None
    save = {"npz": (ds.save_events_npz, jds.save_events_npz),
            "aedat": (ds.save_events_aedat, jds.save_events_aedat)}[fmt]
    load = {"npz": (ds.load_events_npz, jds.load_events_npz),
            "aedat": (ds.load_events_aedat, jds.load_events_aedat)}[fmt]
    kw = {} if fmt == "npz" else {"width": rec.width, "height": rec.height}
    for i, (writer, reader) in enumerate(((save[0], load[1]),
                                          (save[1], load[0]))):
        path = str(tmp_path / f"rec_{i}.{fmt}")
        writer(path, rec)
        back = reader(path, **kw)
        for f in ("t", "x", "y", "p"):
            np.testing.assert_array_equal(getattr(back, f), getattr(rec, f))
        assert (back.width, back.height, back.label) == (
            rec.width, rec.height, rec.label)


# ---------------------------------------------------------------------------
# the card: the N = 1 faces and event_apply (gpu only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _face_case(kind, pairing, pattern):
    """Numpy inputs of one N = 1 launch and the face's extra arguments."""
    if kind == "pool":
        v, w, xyc, gate, s = pool_walk_case("batched", pairing, pattern, 600,
                                            31, N=1)
        return v[0], w, xyc[0], gate[0], (s,)
    if kind == "fc":
        v, w, xyc, gate, in_shape = fc_walk_case(pairing, pattern, 1, 600,
                                                 512, 32, negative=True)
        return v[0], w, xyc[0], gate[0], (in_shape,)
    rng = np.random.default_rng(33)
    v, w = _arrays(rng, (36, 36, 16), (5, 5, 2, 16), pairing)
    xyc, gate = _gate_pattern(rng, pattern, 1, 600, (32, 32, 2),
                              np.arange(1), PAIRINGS[pairing][2], True)
    return v, w, xyc[0], gate[0], ()


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", GATE_PATTERNS)
@pytest.mark.parametrize("pairing", list(PAIRINGS))
@pytest.mark.parametrize("kind", ["conv", "pool", "fc"])
def test_cuda_face_matches_plain(cuda, kind, pairing, pattern):
    face, plain = {"conv": (event_conv, event_conv_ref),
                   "pool": (event_pool, event_pool_ref),
                   "fc": (event_fc, event_fc_ref)}[kind]
    v, w, xyc, gate, extra = _face_case(kind, pairing, pattern)
    args = [_t(a).to(cuda) for a in (v, w, xyc, gate)]
    out = _torch_out(pairing)
    before = LAUNCHES[f"event_{kind}_batched"]
    got = face(*args, *extra, out_dtype=out)
    want = plain(*args, *extra, out_dtype=out)
    torch.cuda.synchronize()
    assert LAUNCHES[f"event_{kind}_batched"] == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(NETS))
def test_cuda_event_apply_matches_cpu(cuda, name):
    spec, params, stream = _net_case(name, "f32-carrier")
    q = quantize_net(params, spec)
    caps = default_capacities(q.spec, activity=0.2, slack=6.0)
    for dp in ("f32-carrier", "int8-native"):
        p = q.params_for(dp)
        want, wst = event_apply(p, q.spec, stream, caps, dtype_policy=dp,
                                device="cpu")
        before = dict(LAUNCHES)
        got, gst = event_apply([EConvParams(w=x.w.to(cuda)) for x in p],
                               q.spec, ev.EventStream(
                                   *(f.to(cuda) for f in stream)), caps,
                               dtype_policy=dp)
        torch.cuda.synchronize()
        for k in ("event_conv_batched", "event_pool_batched",
                  "event_fc_batched"):
            assert LAUNCHES[k] > before[k], k
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
        for a, b in zip(gst.per_layer, wst.per_layer):
            _assert_same_stats(a, b)
