"""The closed loop is desynchronised before the window opens: on a small
net on the CPU, under the runtime's manual clock, completions spread over
the engine windows instead of coming in waves of a slot-count."""
import torch

from perfbench import core, inputs
from perfbench.drivers import closed_serve
from perfbench.program import snn_spec
from perfbench.tests import tiny


def _completions_per_window(monkeypatch, desync: bool, n: int = 20):
    from repro_torch.core.econv import EConvParams
    from repro_torch.core.quant import quantize_net
    from repro_torch.serve.runtime import ManualClock
    if not desync:
        monkeypatch.setattr(closed_serve, "prefix_windows",
                            lambda client, slots, n_windows: n_windows)
    torch.set_num_threads(1)
    cfg, mix = tiny.config(), tiny.serve_mix()
    ctx = tiny.ctx(cfg, mix, runtime_clock=ManualClock())
    w = inputs.make_weights(cfg, 3, ctx.device)
    qn = quantize_net([EConvParams(w=x) for x in w], snn_spec(cfg),
                      per_channel=False)
    loop = closed_serve.ClosedLoop(ctx, inputs.recording_pool(cfg, mix, 3),
                                   qn, core.Spans(), core.WorkMeter(1e-3),
                                   clock=ctx.runtime_clock)
    loop.start()
    while loop.first:
        loop.tick()
    hist = []
    for _ in range(n):
        before = len(loop.completed)
        loop.tick()
        hist.append(len(loop.completed) - before)
    return hist, mix["slots"]


def test_prefixes_cover_whole_windows():
    # 25 windows a request, 64 slots: client i's prefix is ceil(25 (i mod
    # 64 + 1) / 64) windows, from 1 to the whole request
    got = [closed_serve.prefix_windows(i, 64, 25) for i in range(128)]
    assert got[0] == 1 and got[63] == 25 and got[64] == 1
    assert got[:64] == sorted(got[:64])
    assert len(set(got[:64])) == 25


def test_completions_spread_over_windows(monkeypatch):
    hist, slots = _completions_per_window(monkeypatch, desync=True)
    assert max(hist) <= 2 < slots
    assert sum(h > 0 for h in hist) >= len(hist) // 2
    assert sum(hist) >= len(hist)


def test_without_the_prefixes_they_come_in_waves(monkeypatch):
    hist, slots = _completions_per_window(monkeypatch, desync=False)
    assert max(hist) == slots
    assert sum(h > 0 for h in hist) <= len(hist) // 4
