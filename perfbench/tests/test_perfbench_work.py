"""``realtime_streams`` counts work, the result line keeps to the contract,
and the roofline and MFU counts match hand-worked values."""
import json

import numpy as np
import pytest

from perfbench import core, inputs, roofline
from perfbench.reference import ecnn
from perfbench.tests import tiny


def test_half_a_request_counts_half():
    m = core.WorkMeter(timestep_s=1e-3)
    # one 100-step request on one slot, windows of 4 steps, one a second
    for k in range(25):
        m.credit(float(k + 1), 4.0)
    # a window of 12.5 s holds half the request's windows (12 of 25): half
    # of its sensor time, whatever completes
    assert m.served_s(0.0, 12.5) == pytest.approx(0.048)
    assert m.streams(0.0, 12.5) == pytest.approx(0.048 / 12.5)


def test_the_rate_does_not_step_with_completions():
    """Slots finishing together in waves or spread out serve the same work:
    the rate over any window is the same."""
    waves, spread = core.WorkMeter(1e-3), core.WorkMeter(1e-3)
    for k in range(1, 101):
        waves.credit(float(k), 8 * 4.0)        # 8 slots, all in step
        spread.credit(float(k), 8 * 4.0)       # same work, other phases
    for t1 in (30.0, 30.5, 37.0, 61.2):
        assert waves.streams(0.0, t1) == spread.streams(0.0, t1)
        # one more window of a run moves the rate by one window's work, not
        # by a wave of completed requests
        assert abs(waves.streams(0.0, t1) - waves.streams(0.0, t1 + 1.0)) \
            <= 32e-3 / t1


def test_result_line_puts_the_checks_last():
    out = core.Outcome({"x": 1.0}, {}, {"gap": (0.0, 0.0),
                                         "loss": (1e-9, 1e-5)}, 3, 0, 7)
    line = json.loads(core.result_line(out, {"x": (1.0, "s")},
                                       {"platform": "gpu"}))
    assert list(line)[-1] == "checks" and line["correct"] is True
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in line
    assert not core.correct({"gap": (1.0, 0.0)})
    assert not core.correct({"gap": (float("nan"), 1.0)})
    assert not core.correct({})


def _tiny_layers():
    return inputs.layer_shapes(tiny.config())


def test_flops_per_frame_by_hand():
    conv, pool, fc = _tiny_layers()
    # conv 3x3, 2 -> 6 channels on 12x12 (padding 1): 2*9*2*6*144
    # pool 2 on 12x12x6: (4 adds + 1 multiply) * 6*6*6
    # fc 216 -> 4: 2*216*4
    assert ecnn.flops_per_frame([conv]) == 31104
    assert ecnn.flops_per_frame([pool]) == 1080
    assert ecnn.flops_per_frame([fc]) == 1728
    assert ecnn.flops_per_frame(_tiny_layers()) == 33912


def test_serving_work_by_hand():
    layers = _tiny_layers()
    T, W = 8, 4
    ev = np.zeros((1, 3, T), np.int64)
    ev[0, 0, :4] = [10, 0, 5, 5]          # 20 input events in window 0
    ev[0, 1, :4] = [3, 3, 0, 0]           # 6 into the pool
    ev[0, 2, :4] = [2, 0, 0, 1]           # 3 into the fc
    out_ev = np.zeros((1, T), np.int64)
    out_ev[0, :4] = [1, 0, 0, 1]          # 2 out of the fc
    distinct = np.zeros((1, 3, 2), np.int64)
    distinct[0, 2, 0] = 3
    ref = {"events": ev, "out_events": out_ev, "distinct": distinct}
    work = roofline.window_layer_work(layers, ref, W, [(0, 0, 4)])
    # conv: state 12*12*6 read and written, 3*3*2*6 weights, 20 + 6
    # events, 20 * 54 updates
    assert work[0] == (4 * (2 * 864 + 108 + 26), 1080)
    # pool: state 6*6*6, 6 synapses, 6 + 3 events, 6 updates
    assert work[1] == (4 * (2 * 216 + 6 + 9), 6)
    # fc: 4 membranes, the 3 rows named (of 4 columns), 3 + 2 events
    assert work[2] == (4 * (2 * 4 + 12 + 5), 12)
    launches = [(1.0, [(0, 0, 4, 20)])]
    assert roofline.serving_ops(layers, ref, W, launches) == 1098
    want = sum(max(b / 3.35e12, o / 67e12) for b, o in work)
    assert roofline.serving_bound_s(layers, ref, W, launches) == \
        pytest.approx(want)


def test_trace_busy_time_and_idle_gaps_by_hand():
    from perfbench.trace import DeviceTrace
    tr = DeviceTrace(enabled=False)
    tr.t0, tr.t1 = 0.0, 10.0
    tr.events = [("k1", 1.0, 2.0), ("Memcpy HtoD", 1.5, 3.0),
                 ("k2", 6.0, 7.0), ("k1", 9.5, 11.0)]
    assert tr.busy_s() == pytest.approx(2.0 + 1.0 + 0.5)
    assert tr.device_s(lambda n: n == "k1") == pytest.approx(2.5)
    spans = {"collect": [(0.0, 0.9)], "launch": [(3.0, 5.5)]}
    # gaps 0-1 (collect), 3-6 (launch), 7-9.5 (no span)
    assert dict(tr.idle_gaps(spans)) == pytest.approx(
        {"collect": 1.0, "launch": 3.0, "other": 2.5})
    assert tr.top_ops(1) == [["k1", pytest.approx(2.5)]]
