"""``correct`` separates: a sound run of each driver at a small size on the
CPU comes out correct; the lower-precision control in the program's place,
and each fault the cell can have planted under the timed path, come out
not correct."""
import numpy as np
import pytest
import torch

from perfbench import control, core
from perfbench.drivers import closed_serve, train_step
from perfbench.tests import tiny


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _serve():
    return closed_serve.run(tiny.ctx(tiny.config(), tiny.serve_mix()))


def _train():
    return train_step.run(tiny.ctx(tiny.config(n_timesteps=8),
                                   tiny.train_mix()))


def test_sound_runs_are_correct():
    s, t = _serve(), _train()
    assert core.correct(s.checks), s.checks
    assert s.attempted > 0 and s.end_to_end["realtime_streams"] > 0
    assert core.correct(t.checks), t.checks
    assert t.attempted > 0 and t.end_to_end["train_samples_per_s"] > 0


def test_serving_control_int4_state_fails():
    checks = control.serving_control(tiny.config(), tiny.serve_mix(), 11,
                                     torch.device("cpu"))
    assert checks["mismatched_answers"][0] > 0
    assert not core.correct(checks)


@pytest.mark.parametrize("fault", ["tf32", "half_batch"])
def test_training_controls_fail(fault):
    checks = control.training_control(tiny.config(n_timesteps=8),
                                      tiny.train_mix(), 11,
                                      torch.device("cpu"), fault)
    assert not core.correct(checks), checks


def _state_unchanged(params, states, class_counts, ev_xyc, ev_gate, alive,
                     pre_dt, *, program):
    L, N = len(states), ev_xyc.shape[1]
    zero = torch.zeros((L, N), dtype=torch.float32)
    return tuple(states), class_counts, zero, zero.to(torch.int32)


def _half_batch(params, states, class_counts, ev_xyc, ev_gate, alive, pre_dt,
                *, program):
    from repro_torch.core.layer_program import window_step
    gate = ev_gate.clone()
    gate[:, :-(-gate.shape[1] // 2)] = 0
    return window_step(params, states, class_counts, ev_xyc, gate, alive,
                       pre_dt, program=program)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_serving_faults_fail(monkeypatch, fault):
    from repro_torch.serve import event_engine
    if fault == "answer_altered":
        finish = event_engine.EventServeEngine._finish

        def altered(self, slot):
            req = self.slot_req[slot]
            finish(self, slot)
            req.class_counts[0] += 1
        monkeypatch.setattr(event_engine.EventServeEngine, "_finish",
                            altered)
    else:
        monkeypatch.setattr(event_engine, "window_step",
                            {"state_unchanged": _state_unchanged,
                             "half_batch": _half_batch}[fault])
    out = _serve()
    assert not core.correct(out.checks), out.checks


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_training_faults_fail(monkeypatch, fault):
    from repro_torch.train import snn_loop
    make = snn_loop.make_train_step

    def broken(program, cfg):
        step = make(program, cfg)

        def run(params, opt, spikes, labels):
            if fault == "half_batch":
                half = spikes.shape[0] // 2
                return step(params, opt, spikes[:half], labels[:half])
            _, _, metrics = step(params, opt, spikes, labels)
            return params, opt, metrics
        return run
    monkeypatch.setattr(snn_loop, "make_train_step", broken)
    out = _train()
    assert not core.correct(out.checks), out.checks


def test_worst_leaf_gap_by_hand():
    want = [np.full(4, 1.0), np.full(4, 2.0), np.zeros(4)]
    got = [np.full(4, 1.0), np.full(4, 2.2), np.zeros(4)]
    # norms 2 and 4 (median 3); the second differs by 0.4 over max(4, 3)
    assert train_step.worst_leaf_gap(got, want, [0, 1]) == \
        pytest.approx(0.1)
