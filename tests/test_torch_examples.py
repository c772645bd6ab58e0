"""The port's examples (``repro_torch.examples``) against the JAX reference.

Every example runs here through its ``main(argv)`` with ``--device cpu``
(the kernels' plain versions), at tiny size:

* ``serve_events --source file --weights trained`` under every
  ``all_policies()`` cell (the mesh cells on two repeated CPU devices),
  synchronous, and streaming under both dtype policies, returns the
  committed golden ``tests/golden/tiny_gesture_trained_serve.npz`` key for
  key (exact);
* quickstart and event_sparsity's part 1, on the same numpy weights
  (the port's through ``weights.params_from_numpy``), the same sample and
  one numpy thinning field, against the reference's ``event_predict`` /
  ``event_apply``: class counts, events and SOPs exact; part 2's event
  fractions against the reference's ``gated_rglru_step`` on the port's
  RG-LRU parameters carried across (exact: the gate compares inputs
  only);
* train_dvs_gesture at ``--scale tiny --steps 2 --test-n 4``, once with
  ``--mix-recording --save-net``: finite losses, and the saved file read
  back by the reference's ``load_net`` bitwise;
* serve_lm at granite smoke (2 requests, 4 tokens), and its refusal of
  the encoder-decoder config;
* ``kernels.event_conv.ref.selfcheck_batched_bitexact`` on the CPU.

Only the reference's library functions are called, never its example
scripts or ``benchmarks/``.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jev
from repro.core import sne_net as jsn
from repro.core.lm_events import gated_rglru_step as j_gated_step
from repro.core.lm_events import sd_init as j_sd_init
from repro.core.policies import all_policies as j_all_policies
from repro.models.recurrent import rglru_decls as j_rglru_decls
from repro.train.snn_loop import load_net as j_load_net
from repro_torch.core.policies import all_policies
from repro_torch.core.sne_net import init_econv_numpy, tiny_net
from repro_torch.data.events_ds import TINY, batch_at
from repro_torch.examples import (event_sparsity, quickstart, serve_events,
                                  serve_lm, train_dvs_gesture)
from repro_torch.kernels.event_conv.ref import selfcheck_batched_bitexact
from repro_torch.weights import params_from_numpy

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "tiny_gesture_trained_serve.npz")
TRAINED = ["--device", "cpu", "--source", "file", "--weights", "trained",
           "--speedup", "1e6"]


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _assert_golden(res):
    gold = np.load(GOLDEN)
    for k in gold.files:
        np.testing.assert_array_equal(res[k], gold[k], err_msg=k)


def _policy_args(pol):
    args = ["--dtype-policy", pol.dtype_policy, "--fusion-policy",
            pol.fusion_policy, "--backend", pol.backend]
    return args + (["--devices", "cpu,cpu"] if pol.backend == "mesh" else [])


@pytest.mark.parametrize("pol", all_policies(), ids=str)
def test_serve_events_trained_recording_equals_golden(pol, capsys):
    res = serve_events.main(TRAINED + _policy_args(pol))
    _assert_golden(res)
    assert res["n_completed"] == 6 and res["r2"] > 0.99
    assert "6 segment requests" in capsys.readouterr().out


def test_serve_events_policy_matrix_is_the_reference_one():
    assert [dataclasses.asdict(p) for p in all_policies()] == \
        [dataclasses.asdict(p) for p in j_all_policies()]


@pytest.mark.parametrize("dtype_policy", ["f32-carrier", "int8-native"])
def test_serve_events_streaming_equals_golden(dtype_policy):
    res = serve_events.main(TRAINED + ["--mode", "streaming",
                                       "--dtype-policy", dtype_policy,
                                       "--arrival-rate", "1e4"])
    _assert_golden(res)
    rep = res["report"]
    assert rep["completed"] == 6 and rep["rejected_queue_full"] == 0


def test_serve_events_synthetic_source():
    res = serve_events.main(["--device", "cpu", "--requests", "3",
                             "--slots", "2", "--fusion-policy", "per-step"])
    assert res["n_completed"] == 3 and list(res["uids"]) == [0, 1, 2]
    # per-step: one counted launch per layer and timestep of each window
    assert res["stats"]["kernel_launches"] == 3 * 4 * res["stats"][
        "step_calls"]
    assert res["launches"] == 0          # the CPU runs no kernel


@pytest.fixture(scope="module")
def ref_tiny():
    """The reference's ``tiny_net`` spec, numpy weights for both packages
    (the reference takes them as ``jnp`` arrays, the port through
    ``params_from_numpy``) and the examples' sample, the first of
    ``batch_at(0, 0, 4, TINY)`` drawn on the CPU."""
    rng = np.random.default_rng(0)
    arrays = [init_econv_numpy(rng, l) for l in tiny_net().layers]
    spikes = batch_at(0, 0, 4, TINY, device="cpu")[0][0].numpy()
    return jsn.tiny_net(), arrays, spikes


@functools.lru_cache(maxsize=None)
def _j_event_apply():
    return jax.jit(jsn.event_apply, static_argnums=(1, 3, 4))


def _j_counts(spec, arrays, spikes, caps):
    """The reference's event path on ``spikes``: (class counts, events,
    SOPs)."""
    jparams = [jsn.EConvParams(w=jnp.asarray(a)) for a in arrays]
    x = jnp.asarray(spikes)
    stream = jev.dense_to_events(x, jev.capacity_for(x.shape, 0.3,
                                                     slack=4.0))
    out, stats = _j_event_apply()(jparams, spec, stream, tuple(caps),
                                  "f32-carrier")
    c = np.where(np.asarray(out.valid), np.asarray(out.c), spec.n_classes)
    counts = np.bincount(c, minlength=spec.n_classes + 1)[:-1]
    return (counts.astype(np.float32), int(stats.total_events),
            int(stats.total_sops))


def test_quickstart_matches_the_reference_event_predict(ref_tiny):
    jspec, arrays, spikes = ref_tiny
    spec = tiny_net()
    got = quickstart.run(params_from_numpy(arrays, spec, "cpu"), spec,
                         torch.from_numpy(spikes), "cpu")
    counts, events, sops = _j_counts(
        jspec, arrays, spikes,
        jsn.default_capacities(jspec, activity=0.2, slack=6.0))
    np.testing.assert_array_equal(got["class_counts"], counts)
    assert (got["total_events"], got["total_sops"]) == (events, sops)
    assert got["pred_event"] == got["pred_dense"] == int(np.argmax(counts))


def test_quickstart_main_runs_on_the_cpu(capsys):
    out = quickstart.main(["--device", "cpu"])
    assert out["pred_event"] == out["pred_dense"]
    assert out["total_events"] > 0 and 0 < out["activity"] < 1
    assert "event path == dense path: OK" in capsys.readouterr().out


def test_event_sparsity_part1_matches_the_reference(ref_tiny):
    jspec, arrays, spikes = ref_tiny
    field = np.random.default_rng(1).random(spikes.shape)
    rows = event_sparsity.sweep_activity(
        params=params_from_numpy(arrays, tiny_net(), "cpu"),
        spikes=torch.from_numpy(spikes), field=field, device="cpu")
    caps = jsn.default_capacities(jspec, activity=0.3, slack=6.0)
    events = []
    for r in rows:
        mask = (field < r["activity_frac"]).astype(np.float32)
        _, ev_n, sops = _j_counts(jspec, arrays, spikes * mask, caps)
        assert (r["events"], r["sops"]) == (ev_n, sops), r
        events.append(ev_n)
    # the nested thinning: more of the field kept, more events
    assert events == sorted(events) and events[0] < events[-1]
    r2 = event_sparsity.r_squared(events, [r["energy_uj"] for r in rows])
    assert r2 > 0.999


def test_event_sparsity_part2_matches_the_reference():
    d, steps, seed = 32, 16, 0
    p = event_sparsity._rglru_params(seed, d, torch.device("cpu"))
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    assert {k: v.shape for k, v in jp.items()} == {
        k: decl.shape for k, decl in j_rglru_decls(d, d, 4).items()}
    rows = event_sparsity.sweep_sigma_delta(seed=seed, d=d, steps=steps,
                                            params=p, device="cpu")
    step = jax.jit(j_gated_step)
    rng = np.random.default_rng(seed)
    for r, th in zip(rows, event_sparsity.THRESHOLDS):
        sd, h = j_sd_init(jnp.zeros((1, d))), jnp.zeros((1, d), jnp.float32)
        base = rng.normal(size=(1, d)).astype(np.float32)
        fracs = 0.0
        for _ in range(steps):
            x = jnp.asarray(base + 0.08 * rng.normal(size=(1, d))
                            .astype(np.float32))
            _, h, sd, frac = step(jp, x, h, sd, th)
            fracs += float(frac)
        assert r["threshold"] == th and r["event_frac"] == fracs / steps
    assert rows[0]["event_frac"] == 1.0
    assert rows[-1]["event_frac"] < rows[0]["event_frac"]


@pytest.mark.parametrize("extra", [[], ["--mix-recording", "--save-net"]],
                         ids=["plain", "mix_and_save"])
def test_train_dvs_gesture_tiny(extra, tmp_path, capsys):
    if extra:
        extra = extra + [str(tmp_path / "net.npz")]
    out = train_dvs_gesture.main(["--device", "cpu", "--scale", "tiny",
                                  "--steps", "2", "--test-n", "4", "--qat"]
                                 + extra)
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert 0.0 <= out["agreement"] <= 1.0 and out["mean_events"] > 0
    assert len(out["event_ms"]) == 4
    text = capsys.readouterr().out
    assert "accuracy: dense=" in text
    if extra:
        assert "mixing 6 recording windows" in text
        params, meta = j_load_net(extra[-1], jsn.tiny_net())
        for a, b in zip(params, out["params"]):
            np.testing.assert_array_equal(np.asarray(a.w), _np(b.w))
        assert int(meta["steps"]) == 2 and int(meta["qat"]) == 1


def test_train_dvs_gesture_refuses_a_mix_off_tiny():
    with pytest.raises(SystemExit, match="needs --scale tiny"):
        train_dvs_gesture.main(["--device", "cpu", "--scale", "nmnist",
                                "--mix-recording", "--steps", "1"])


def test_serve_lm_granite_smoke():
    out = serve_lm.main(["--device", "cpu", "--arch", "granite-8b",
                         "--requests", "2", "--max-tokens", "4",
                         "--temperature", "0"])
    assert all(out["done"]) and [len(t) for t in out["tokens"]] == [4, 4]
    assert out["stats"]["prefill_tokens"] > 0


def test_serve_lm_refuses_encoder_decoder():
    with pytest.raises(SystemExit, match="decoder-only"):
        serve_lm.main(["--device", "cpu", "--arch", "whisper-medium"])


@pytest.mark.parametrize("shape", [(3, 16, 16, 8, 3, 2, 40),
                                   (2, 12, 12, 16, 5, 4, 64)])
def test_selfcheck_batched_bitexact_on_the_cpu(shape):
    selfcheck_batched_bitexact(*shape, seed=1, device="cpu")
