"""The port's training path and dense path against the JAX reference.

The same numpy inputs go through the reference and the port, on the CPU:

* ``spike_fn``, ``_ste_round``, ``lif_step`` and ``lif_rollout``: forward
  bitwise; surrogate gradients against ``jax.grad`` at rtol 1e-5, ties
  included (``|v|`` equal to the leak, a membrane on the clip bound, ``v``
  equal to the threshold, ``v = 0``); the surrogate's closed form by a
  float64 ``gradcheck``;
* ``fake_quant_net`` bitwise equal to the port's own
  ``quantize_net(per_channel=False).dequantized_params()`` and to the
  reference's ``fake_quant_net``; QAT gradients at rtol 1e-5, the weight
  on code 7 included;
* ``dense_program_forward`` / ``dense_apply`` with ``train`` and ``qat``
  on dyadic weights (multiples of 2^-3 whose largest magnitude per output
  channel is on code 7, so every partial sum, and every fake-quantised
  weight, is exact in float32 whatever the order): every layer's spikes
  bitwise; the int8 program is refused;
* the losses and rate decoding; one QAT train step: loss and per-layer
  gradients at rtol 1e-4 / atol 1e-6;
  ``adamw_update``, ``sgd_update`` and the schedules on identical inputs at
  rtol 1e-6; five steps on batches of the reference's ``batch_at`` (see
  ``test_five_steps_match_jax`` for the tolerance);
* the synthetic sampler's body on the reference's draws (spikes differ
  only where ``|u - prob| < 1e-6``), the recording windows bitwise, and a
  net the port trains and ``save_net`` writes, read by the reference's
  ``load_net`` and served by the reference's engine, equal to the port's
  engine class for class.

Port-only: ``fit`` resumes bitwise, pool weights stay frozen, the
recording mix is deterministic and an empty one refused, ``TrainConfig``
validates, a 20-step tiny run's loss falls, checkpoints keep the last k
and check their target, the fault hooks fire.  The ``gpu`` tests (skipped
without a card) hold the card's step against the CPU's, resume and
serving of the trained net on the card, and the dense path's numerics:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_train.py
"""
import dataclasses
import importlib
import os
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import optim
from repro_torch.core import lif, quant
from repro_torch.core.econv import EConvParams, dense_math
from repro_torch.core.layer_program import (compile_program,
                                            dense_program_forward)
from repro_torch.core.policies import ExecutionPolicy
from repro_torch.core.sne_net import dense_apply, init_snn, tiny_net
from repro_torch.data import events_ds as ds
from repro_torch.serve import EventServeEngine
from repro_torch.train import snn_loop as loop
from repro_torch.weights import save_net

torch.set_num_threads(1)
T = 8
WINDOW_US = 1000


class _Lazy:
    """A module of the reference, imported on first use: the card's
    machine has no JAX, and the gpu tests never touch one."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


jax, jnp = _Lazy("jax"), _Lazy("jax.numpy")
jlif, jquant = _Lazy("repro.core.lif"), _Lazy("repro.core.quant")
jecv, jlp = _Lazy("repro.core.econv"), _Lazy("repro.core.layer_program")
jpol = _Lazy("repro.core.policies")
jsn, jds = _Lazy("repro.core.sne_net"), _Lazy("repro.data.events_ds")
jopt, jsched = _Lazy("repro.optim.optimizers"), _Lazy(
    "repro.optim.schedules")
jserve, jloop = _Lazy("repro.serve"), _Lazy("repro.train.snn_loop")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jparams(arrays):
    return [jecv.EConvParams(w=jnp.asarray(a)) for a in arrays]


def _tparams(arrays, device="cpu"):
    return [EConvParams(w=_t(a).to(device)) for a in arrays]


def _dyadic(rng, spec, shift=3):
    """Weights on the 2^-shift grid, |code| <= 7, with code 7 in every
    output channel (so each fake-quant scale is exactly 2^-shift)."""
    out = []
    for l in spec.layers:
        if l.kind == "pool":
            out.append(np.ones(l.weight_shape, np.float32))
            continue
        q = rng.integers(-7, 8, l.weight_shape)
        q.reshape(-1, q.shape[-1])[rng.integers(0, q.size // q.shape[-1])] = 7
        out.append((q * 2.0 ** -shift).astype(np.float32))
    return out


def _spikes(rng, n, spec, p=0.15):
    return (rng.random((n, spec.n_timesteps) + spec.in_shape) < p).astype(
        np.float32)


def _close(a, b, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# LIF: forward bitwise, gradients as jax.grad
# ---------------------------------------------------------------------------

def _membranes(rng, shape, leak, clip):
    """Dyadic membranes with the tie cases planted: 0, +-leak, the
    threshold, the clip bounds."""
    v = (rng.integers(-64, 65, shape) / 32.0).astype(np.float32)
    flat = v.reshape(-1)
    flat[:6] = [0.0, leak, -leak, 1.0, 2 * leak, -2 * leak]
    if clip is not None:
        flat[6:8] = [clip + leak, -clip - leak]
    return v


@pytest.mark.parametrize("leak_mode", ["toward_zero", "subtract"])
@pytest.mark.parametrize("reset_mode", ["zero", "subtract"])
def test_lif_step_and_rollout_match_jax(reset_mode, leak_mode):
    """With and without the clip: the step's and the rollout's outputs
    bitwise, with and without the surrogate (the reference's forward is
    the same for both); with the clip (every tie planted), d/dv and d/dsyn
    through the surrogate at rtol 1e-5 (atol 1e-7)."""
    rng = np.random.default_rng(1)
    leak = 0.03125
    for clip in (None, 1.5):
        kw = dict(threshold=1.0, leak=leak, leak_mode=leak_mode,
                  reset_mode=reset_mode, state_clip=clip)
        p, jp = lif.LifParams(**kw), jlif.LifParams(**kw)
        v0 = _membranes(rng, (4, 4, 3), leak, clip)
        syn = (rng.integers(-16, 17, (5, 4, 4, 3)) / 32.0).astype(np.float32)
        syn[0].reshape(-1)[:8] = 0.0      # keep the planted ties
        gv = rng.standard_normal((4, 4, 3)).astype(np.float32)
        gs = rng.standard_normal((5, 4, 4, 3)).astype(np.float32)

        def jfun(v, x):
            a, b = jlif.lif_step(v, x[0], jp, True)
            c, d = jlif.lif_rollout(v, x, jp, True)
            return (jnp.sum(a * gv) + jnp.sum(b * gv) + jnp.sum(c * gv)
                    + jnp.sum(d * gs)), (a, b, c, d)

        jv0, jsyn = jnp.asarray(v0), jnp.asarray(syn)
        if clip:
            (jv, jx), ref = jax.grad(jfun, argnums=(0, 1), has_aux=True)(
                jv0, jsyn)
        else:
            ref = jfun(jv0, jsyn)[1]
        for train in (False, True):
            tv, tx = _t(v0).requires_grad_(), _t(syn).requires_grad_()
            a, b = lif.lif_step(tv, tx[0], p, train)
            c, d = lif.lif_rollout(tv, tx, p, train)
            for mine, want in zip((a, b, c, d), ref):
                np.testing.assert_array_equal(mine.detach().numpy(),
                                              np.asarray(want))
        if clip:
            loss = ((a * _t(gv)).sum() + (b * _t(gv)).sum()
                    + (c * _t(gv)).sum() + (d * _t(gs)).sum())
            gtv, gtx = torch.autograd.grad(loss, (tv, tx))
            _close(gtv, jv, 1e-5, 1e-7)
            _close(gtx, jx, 1e-5, 1e-7)
            assert np.abs(np.asarray(jx)).max() > 0


@pytest.mark.parametrize("threshold", [1.0, 0.999, 14.0])
def test_spike_fn_matches_jax(threshold):
    """Forward bitwise (values on the threshold included); the surrogate
    gradient at rtol 1e-5."""
    rng = np.random.default_rng(2)
    v = (rng.standard_normal(257) * 2 * threshold).astype(np.float32)
    v[:3] = [threshold, np.float32(threshold), 0.0]
    g = rng.standard_normal(257).astype(np.float32)
    ref = jlif.spike_fn(jnp.asarray(v), threshold, 10.0)
    jg = jax.grad(lambda x: jnp.sum(jlif.spike_fn(x, threshold, 10.0) * g))(
        jnp.asarray(v))
    tv = _t(v).requires_grad_()
    out = lif.spike_fn(tv, threshold, 10.0)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    (tg,) = torch.autograd.grad((out * _t(g)).sum(), tv)
    _close(tg, jg, 1e-5)


def test_surrogate_is_the_derivative_of_its_closed_form():
    """float64 gradcheck: the backward of ``spike_fn`` is the derivative of
    ``sign(x)·(1/2 − 1/(2(1 + β|x|)))``, ``x = v − th``."""
    th, beta = 0.75, 10.0

    class Primitive(torch.autograd.Function):
        @staticmethod
        def forward(ctx, v):
            ctx.save_for_backward(v)
            ctx.threshold, ctx.beta = th, beta
            x = v - th
            return torch.sign(x) * (0.5 - 0.5 / (1.0 + beta * x.abs()))

        @staticmethod
        def backward(ctx, g):
            return lif._SpikeFn.backward(ctx, g)[0]

    v = torch.linspace(-2.0, 3.0, 101, dtype=torch.float64)
    v = v[(v - th).abs() > 1e-3].clone().requires_grad_()
    assert torch.autograd.gradcheck(Primitive.apply, (v,), eps=1e-6,
                                    atol=1e-7, rtol=1e-6)


def test_ste_round_matches_jax():
    """Round half to even, bitwise; the gradient is the identity."""
    x = np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, 0.49, 6.5, -7.5, 3.2],
                   np.float32)
    tx = _t(x).requires_grad_()
    out = quant._ste_round(tx)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jquant._ste_round(x)))
    (g,) = torch.autograd.grad((out * 3.0).sum(), tx)
    np.testing.assert_array_equal(g.numpy(), np.full_like(x, 3.0))


# ---------------------------------------------------------------------------
# QAT fake-quant
# ---------------------------------------------------------------------------

def test_fake_quant_net_is_the_deployment_grid_and_matches_jax():
    """Bitwise: the port's fake_quant_net == its quantize_net(per_channel=
    False).dequantized_params() == the reference's fake_quant_net; the
    per-channel view too.  QAT gradients at rtol 1e-5 (the conv layer on
    the shared grid, the fc layer per channel), the largest weight of each
    on code 7, where the clip's tie passes half."""
    spec, jspec = tiny_net(), jsn.tiny_net()
    arrays = [p.w.numpy() for p in init_snn(np.random.default_rng(5), spec,
                                            device="cpu")]
    params = _tparams(arrays)
    fq = quant.fake_quant_net(params, spec)
    dq = quant.quantize_net(params, spec, per_channel=False
                            ).dequantized_params()
    jfq = jquant.fake_quant_net(_jparams(arrays), jspec)
    for i, (a, b, c, l) in enumerate(zip(fq, dq, jfq, spec.layers)):
        np.testing.assert_array_equal(a.w.numpy(), np.asarray(c.w),
                                      err_msg=f"layer {i}")
        if l.kind != "pool":
            np.testing.assert_array_equal(a.w.numpy(), b.w.numpy(),
                                          err_msg=f"layer {i}")
    rng = np.random.default_rng(6)
    # the conv layer on the shared grid, the fc layer per channel
    for w, per_channel in ((arrays[0], False), (arrays[2], True)):
        g = rng.standard_normal(w.shape).astype(np.float32)
        ref = jquant.fake_quant_weights(jnp.asarray(w), per_channel)
        jg = jax.grad(lambda x: jnp.sum(
            jquant.fake_quant_weights(x, per_channel) * g))(jnp.asarray(w))
        tw = _t(w).requires_grad_()
        out = quant.fake_quant_weights(tw, per_channel)
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
        (tg,) = torch.autograd.grad((out * _t(g)).sum(), tw)
        _close(tg, jg, 1e-5, 1e-7, f"per_channel={per_channel}")


# ---------------------------------------------------------------------------
# The dense path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qat", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_dense_forward_matches_jax(train, qat):
    """dense_program_forward and dense_apply on a batch of 2: every layer's
    spikes bitwise equal to the reference's (mapped over the batch)."""
    rng = np.random.default_rng(7)
    spec, jspec = tiny_net(T), jsn.tiny_net(T)
    arrays = _dyadic(rng, spec)
    x = _spikes(rng, 2, spec)
    program = compile_program(spec, device="cpu")
    jprogram = jlp.compile_program(jspec)
    _, acts = dense_program_forward(program, _tparams(arrays), _t(x),
                                    train=train, qat=qat)
    _, acts2 = dense_apply(_tparams(arrays), spec, _t(x), train=train,
                           qat=qat)
    jp = _jparams(arrays)
    _, ja = jax.vmap(lambda v: jlp.dense_program_forward(
        jprogram, jp, v, train=train, qat=qat))(jnp.asarray(x))
    _, ja2 = jax.vmap(lambda v: jsn.dense_apply(
        jp, jspec, v, train=train, qat=qat))(jnp.asarray(x))
    for i in range(len(spec.layers)):
        np.testing.assert_array_equal(acts[i].numpy(), np.asarray(ja[i]))
        np.testing.assert_array_equal(acts2[i].numpy(), np.asarray(ja2[i]))
    assert all(0 < float(a.mean()) < 1 for a in acts)


def test_dense_program_forward_refuses_the_int8_program():
    spec = tiny_net(T)
    qn = quant.quantize_net(init_snn(np.random.default_rng(0), spec,
                                     device="cpu"), spec)
    program = compile_program(qn.spec, device="cpu", policy=ExecutionPolicy(
        dtype_policy="int8-native", fusion_policy="per-step"))
    with pytest.raises(ValueError, match="f32-carrier"):
        dense_program_forward(program, qn.params_for("int8-native"),
                              torch.zeros((T,) + spec.in_shape))


# ---------------------------------------------------------------------------
# The train step and the optimizers
# ---------------------------------------------------------------------------

def test_losses_and_rate_decoding_match_jax():
    """``spike_counts`` and ``predict`` (a tie goes to the first class)
    bitwise, ``count_loss`` and ``ce_loss`` per sample at rtol 1e-6, on
    output spikes of a batch of 3."""
    from repro_torch.core import sne_net
    rng = np.random.default_rng(12)
    spec = tiny_net()
    out = (rng.random((3, spec.n_timesteps, 1, 1, spec.n_classes))
           < 0.4).astype(np.float32)
    out[2, :, 0, 0, :2] = 1.0                      # classes 0 and 1 tie
    lab = np.asarray([1, 3, 0])
    counts = sne_net.spike_counts(_t(out))
    assert int(sne_net.predict(_t(out))[2]) == 0
    for b in range(3):
        jo, jl = jnp.asarray(out[b]), jnp.asarray(lab[b])
        np.testing.assert_array_equal(counts[b].numpy(),
                                      np.asarray(jsn.spike_counts(jo)))
        assert int(sne_net.predict(_t(out))[b]) == int(jsn.predict(jo))
        _close(sne_net.count_loss(_t(out), _t(lab), spec)[b],
               jsn.count_loss(jo, jl, jsn.tiny_net()), 1e-6)
        _close(sne_net.ce_loss(_t(out), _t(lab))[b], jsn.ce_loss(jo, jl),
               1e-6)


def test_loss_and_gradients_match_jax():
    """One QAT step's loss and every layer's gradient (pool layers before
    their zeroing) at rtol 1e-4 / atol 1e-6."""
    qat, loss = True, "ce"
    rng = np.random.default_rng(8)
    spec, jspec = tiny_net(T), jsn.tiny_net(T)
    arrays = _dyadic(rng, spec)
    x, lab = _spikes(rng, 3, spec), rng.integers(0, spec.n_classes, 3)
    jl, jg = jax.value_and_grad(lambda p: jloop.batch_loss(
        jlp.compile_program(jspec), p, jnp.asarray(x), jnp.asarray(lab),
        qat=qat, loss=loss))(_jparams(arrays))
    leaves = [_t(a).requires_grad_() for a in arrays]
    with dense_math():
        tl = loop.batch_loss(compile_program(spec, device="cpu"),
                             [EConvParams(w=w) for w in leaves], _t(x),
                             _t(lab), qat=qat, loss=loss)
        tg = torch.autograd.grad(tl, leaves)
    _close(tl.detach(), jl, 1e-4)
    for i, (a, b) in enumerate(zip(tg, jg)):
        _close(a, b.w, 1e-4, 1e-6, f"layer {i}")
        assert np.abs(np.asarray(b.w)).max() > 0


def _opt_inputs(rng, scale):
    shapes = [(3, 3, 2, 4), (4,), (36, 5)]
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    gs = [(rng.standard_normal(s) * scale).astype(np.float32)
          for s in shapes]
    mus = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in shapes]
    nus = [(rng.random(s) * 0.01).astype(np.float32) for s in shapes]
    return ps, gs, mus, nus


@pytest.mark.parametrize("grad_scale", [0.01, 3.0])   # clip off / on
def test_optimizers_and_schedules_match_jax(grad_scale):
    """adamw_update and sgd_update on identical inputs, and the four
    schedules over 30 steps, at rtol 1e-6 (atol 1e-9)."""
    rng = np.random.default_rng(9)
    ps, gs, mus, nus = _opt_inputs(rng, grad_scale)
    step = np.int32(3)
    lr = np.float32(3e-3)
    jn, js, jm = jopt.adamw_update(
        [jnp.asarray(g) for g in gs],
        jopt.AdamWState(jnp.asarray(step), [jnp.asarray(m) for m in mus],
                        [jnp.asarray(n) for n in nus]),
        [jnp.asarray(p) for p in ps], jnp.asarray(lr), weight_decay=0.01)
    tn, ts, tm = optim.adamw_update(
        [_t(g) for g in gs],
        optim.AdamWState(torch.tensor(step), [_t(m) for m in mus],
                         [_t(n) for n in nus]),
        [_t(p) for p in ps], torch.tensor(lr), weight_decay=0.01)
    assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step)
    _close(tm["grad_norm"], jm["grad_norm"], 1e-6)
    assert (float(jm["grad_norm"]) > 1.0) == (grad_scale > 1)
    for a, b in zip(tn + ts.mu + ts.nu, jn + js.mu + js.nu):
        _close(a, b, 1e-6, 1e-9)
    jn, js, _ = jopt.sgd_update(
        [jnp.asarray(g) for g in gs],
        jopt.SgdState(jnp.asarray(step), [jnp.asarray(m) for m in mus]),
        [jnp.asarray(p) for p in ps], jnp.asarray(lr))
    tn, ts, _ = optim.sgd_update(
        [_t(g) for g in gs],
        optim.SgdState(torch.tensor(step), [_t(m) for m in mus]),
        [_t(p) for p in ps], torch.tensor(lr))
    for a, b in zip(tn + ts.velocity, jn + js.velocity):
        _close(a, b, 1e-6, 1e-9)
    assert int(ts.step) == 4
    for name, args in (("constant", (3e-3,)), ("linear_warmup", (3e-3, 7)),
                       ("cosine_decay", (3e-3, 20)),
                       ("warmup_cosine", (3e-3, 4, 20))):
        f, jf = getattr(optim, name)(*args), getattr(jsched, name)(*args)
        for s in range(30):
            got = f(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            _close(got, jf(jnp.asarray(s, jnp.int32)), 1e-6, 0, name)


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_five_steps_match_jax(optimizer):
    """Five steps of ``make_train_step`` from the same dyadic weights on
    the reference's ``batch_at`` batches.  Losses (and AdamW's gradient
    norms) at rtol 1e-4; weights at
    rtol 1e-4 / atol 1e-6.  AdamW moves a weight by about ``lr`` per step
    whatever its gradient's size, so a gradient at float32 rounding level
    (the two frameworks sum in other orders) would move it by noise: at
    most 1% of a layer's weights may therefore differ by up to the summed
    learning rate, the most such noise can move them.  (A weight whose
    gradient is exactly 0 in both moves by exactly ``0/(0 + eps)``.)  QAT
    is off here: its membranes lie on the lattice of each layer's scale,
    within an ulp of the threshold, so after the first update another
    summation order flips spikes; QAT's step is held by
    ``test_loss_and_gradients_match_jax`` on exact weights."""
    cfg = jloop.TrainConfig(steps=5, batch=4, optimizer=optimizer)
    tcfg = loop.TrainConfig(**dataclasses.asdict(cfg))
    spec, jspec = tiny_net(), jsn.tiny_net()
    arrays = _dyadic(np.random.default_rng(10), spec)
    jstep = jloop.make_train_step(jlp.compile_program(jspec), cfg)
    tstep = loop.make_train_step(compile_program(spec, device="cpu"), tcfg)
    jp, tp = _jparams(arrays), _tparams(arrays)
    jo, to = jloop.init_opt(jp, cfg), loop.init_opt(tp, tcfg)
    lr_sum = 0.0
    for i in range(cfg.steps):
        x, lab = jds.batch_at(cfg.seed, i, cfg.batch, jds.TINY)
        jp, jo, jm = jstep(jp, jo, x, lab)
        tp, to, tm = tstep(tp, to, _t(np.asarray(x)),
                           _t(np.asarray(lab)).long())
        _close(tm["loss"], jm["loss"], 1e-4, 0, f"step {i}")
        _close(tm["lr"], jm["lr"], 1e-6)
        if optimizer == "adamw":
            _close(tm["grad_norm"], jm["grad_norm"], 1e-4, 0, f"step {i}")
        lr_sum += float(jm["lr"])
    for i, (a, b, l) in enumerate(zip(tp, jp, spec.layers)):
        a, b = a.w.numpy(), np.asarray(b.w)
        if l.kind == "pool" or optimizer == "sgd":
            _close(a, b, 1e-4, 1e-6, f"layer {i}")
            continue
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-6)
        assert off.mean() <= 0.01, (i, off.mean())
        assert np.abs(a - b).max() <= lr_sum * (1 + 1e-4), i


# ---------------------------------------------------------------------------
# Data: the sampler body, batches, recording windows
# ---------------------------------------------------------------------------

def test_sampler_body_matches_jax_on_its_draws():
    """The reference's draws through the port's body (TINY): the spikes
    equal the reference's wherever ``u`` is at least 1e-6 from the port's
    probability (checked by moving ``u`` by 1e-6 each way); the three
    dataset specs are the reference's."""
    for name in ("DVS_GESTURE", "NMNIST", "TINY"):
        assert dataclasses.asdict(getattr(ds, name)) == dataclasses.asdict(
            getattr(jds, name))
    spec, jspec = ds.TINY, jds.TINY
    for seed in (3,):
        k_lab, k_data = jax.random.split(jax.random.PRNGKey(seed))
        label = jax.random.randint(k_lab, (), 0, jspec.n_classes)
        k_phase, k_noise, k_act = jax.random.split(k_data, 3)
        phase_u = np.asarray(jax.random.uniform(k_phase, (jspec.n_blobs,)))
        act_u = np.asarray(jax.random.uniform(k_act, (), minval=0.6,
                                              maxval=2.4))
        u = np.asarray(jax.random.uniform(
            k_noise, (jspec.n_timesteps, jspec.height, jspec.width,
                      jspec.polarities)))
        ref = np.asarray(jds._sample_one(k_data, label, jspec))

        def body(uu):
            return ds._sample_one(_t(np.asarray(label)).reshape(1),
                                  _t(phase_u)[None], _t(act_u).reshape(1),
                                  _t(uu)[None], spec)[0].numpy()

        mine = body(u)
        assert (mine != ref).mean() < 1e-4
        assert (body(u + np.float32(1e-6)) <= ref).all()
        assert (ref <= body(u - np.float32(1e-6))).all()
        assert 0.005 < ref.mean() < 0.2


def test_batch_at_is_a_pure_function_of_seed_and_index():
    a, la = ds.batch_at(0, 3, 4, ds.TINY, device="cpu")
    b, lb = ds.batch_at(0, 3, 4, ds.TINY, device="cpu")
    c, _ = ds.batch_at(0, 4, 4, ds.TINY, device="cpu")
    d, _ = ds.batch_at(1, 3, 4, ds.TINY, device="cpu")
    assert a.shape == (4, 16, 12, 12, 2) and a.dtype == torch.float32
    assert la.dtype == torch.int64 and int(la.max()) < ds.TINY.n_classes
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert not torch.equal(a, c) and not torch.equal(a, d)
    assert set(a.unique().tolist()) <= {0.0, 1.0}
    gen = iter(ds.batches(0, 4, ds.TINY, device="cpu"))
    next(gen), next(gen), next(gen)
    assert torch.equal(next(gen)[0], a)
    one, lab = ds.sample(torch.Generator().manual_seed(0), ds.TINY)
    assert one.shape == (16, 12, 12, 2) and lab.dim() == 0


def _first_segments(rec, n, seg_us):
    """``rec`` cut to its first ``n`` segments of ``seg_us``."""
    keep = rec.t < rec.t[0] + n * seg_us
    return dataclasses.replace(rec, t=rec.t[keep], x=rec.x[keep],
                               y=rec.y[keep], p=rec.p[keep])


def test_recording_windows_match_jax():
    """The bundled recording's first three windows, bitwise."""
    spec = tiny_net()
    rec, jrec = (_first_segments(m.load_recording(m.sample_recording_path()),
                                 3, spec.n_timesteps * WINDOW_US)
                 for m in (ds, jds))
    wins, labels = ds.recording_dense_windows(rec, spec.in_shape,
                                              spec.n_timesteps, WINDOW_US)
    jwins, jlabels = jds.recording_dense_windows(jrec, spec.in_shape,
                                                 spec.n_timesteps, WINDOW_US)
    assert wins.shape[0] == 3 and wins.sum() > 0
    np.testing.assert_array_equal(wins.numpy(), np.asarray(jwins))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))


# ---------------------------------------------------------------------------
# fit: resume, frozen pools, recording mix, config; the artifact
# ---------------------------------------------------------------------------

CURVE_CFG = loop.TrainConfig(steps=20, batch=4, qat=True)


@pytest.fixture(scope="module")
def curve():
    return loop.fit(tiny_net(), ds.TINY, CURVE_CFG, device="cpu")


def test_fit_resume_is_bitwise(tmp_path, curve):
    """A run interrupted at step 10 (its step-20 checkpoint deleted) and
    resumed under the same config ends with bitwise the uninterrupted
    run's weights and tail losses."""
    import shutil
    first = loop.fit(tiny_net(), ds.TINY, CURVE_CFG, ckpt_dir=str(tmp_path),
                     ckpt_every=10, device="cpu", log_fn=lambda s: None)
    np.testing.assert_array_equal(first.losses, curve.losses)
    shutil.rmtree(tmp_path / "step_00000020")
    second = loop.fit(tiny_net(), ds.TINY, CURVE_CFG, ckpt_dir=str(tmp_path),
                      ckpt_every=10, device="cpu", log_fn=lambda s: None)
    assert second.start_step == 10 and len(second.step_s) == 10
    np.testing.assert_array_equal(second.losses, curve.losses[10:])
    for a, b in zip(second.params, curve.params):
        assert torch.equal(a.w, b.w)


def test_pool_frozen_and_loss_falls(curve):
    spec = tiny_net()
    init = init_snn(np.random.default_rng(CURVE_CFG.seed), spec,
                    device="cpu")
    for p0, p1, l in zip(init, curve.params, spec.layers):
        assert torch.equal(p0.w, p1.w) == (l.kind == "pool")
    assert np.isfinite(curve.losses).all()
    assert float(np.mean(curve.losses[-5:])) < float(
        np.mean(curve.losses[:5]))


def test_fit_with_recording_mix():
    spec = tiny_net()
    wins, labels = ds.recording_dense_windows(
        ds.load_recording(ds.sample_recording_path()), spec.in_shape,
        spec.n_timesteps, WINDOW_US)
    cfg = loop.TrainConfig(steps=2, batch=4)
    a = loop.fit(spec, ds.TINY, cfg, recording=(wins, labels), device="cpu")
    b = loop.fit(spec, ds.TINY, cfg, recording=(wins, labels), device="cpu")
    c = loop.fit(spec, ds.TINY, cfg, device="cpu")
    np.testing.assert_array_equal(a.losses, b.losses)
    assert not np.array_equal(a.losses, c.losses)
    with pytest.raises(ValueError, match="at least one window"):
        loop.fit(spec, ds.TINY, cfg, recording=(wins[:0], labels[:0]),
                 device="cpu")


def test_train_config_validation():
    with pytest.raises(ValueError, match="loss"):
        loop.TrainConfig(loss="mse")
    with pytest.raises(ValueError, match="optimizer"):
        loop.TrainConfig(optimizer="lion")
    with pytest.raises(ValueError, match="positive"):
        loop.TrainConfig(steps=0)


def test_checkpoint_keeps_the_last_k_and_checks_its_target(tmp_path):
    from repro_torch.train import checkpoint as ck
    tree = ([EConvParams(w=torch.arange(6.0).reshape(2, 3))],
            optim.sgd_init([torch.zeros(2, 3)]))
    assert ck.latest(str(tmp_path)) is None
    for step in (1, 2, 3, 4):
        ck.save(str(tmp_path), step, tree, extras={"next_step": step},
                keep_last=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]
    assert ck.latest(str(tmp_path)) == 4
    back, extras = ck.restore(str(tmp_path), 4, tree)
    assert extras == {"next_step": 4}
    assert torch.equal(back[0][0].w, tree[0][0].w)
    assert back[1].step.dtype == torch.int32
    assert type(back[1]) is optim.SgdState
    with pytest.raises(ValueError, match="shape"):
        ck.restore(str(tmp_path), 4, ([EConvParams(w=torch.zeros(3, 2))],
                                      tree[1]))
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore(str(tmp_path), 4, (tree[0], tree[1], torch.zeros(1)))


def test_fault_hooks():
    import signal
    from repro_torch.train.fault import (PreemptionGuard, StepWatchdog,
                                         with_retries)
    guard = PreemptionGuard()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.requested
    finally:
        guard.restore()
    seen = []
    dog = StepWatchdog(threshold=3.0, on_straggler=lambda *a: seen.append(a))
    dog.ema = 1e-6
    dog.start()
    time.sleep(0.01)
    dog.stop(7)
    assert seen and seen[0][0] == 7 and dog.events[0]["step"] == 7
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert with_retries(flaky, base_delay=0.0) == "ok" and len(calls) == 3
    with pytest.raises(OSError):
        with_retries(lambda: (_ for _ in ()).throw(OSError("down")), n=2,
                     base_delay=0.0)


def test_port_trained_net_is_served_by_the_reference(tmp_path, curve):
    """``save_net`` of the port's trained net -> the reference's
    ``load_net`` -> the reference's engine: class counts equal the port's
    engine's on the bundled recording (f32-carrier, per-step: the
    lowering every other one is held to bitwise)."""
    path = str(tmp_path / "net.npz")
    save_net(path, curve.params, meta={"steps": CURVE_CFG.steps})
    jparams, meta = jloop.load_net(path, jsn.tiny_net())
    assert int(meta["steps"]) == CURVE_CFG.steps
    for a, b in zip(jparams, curve.params):
        np.testing.assert_array_equal(np.asarray(a.w), b.w.numpy())
    qn = quant.quantize_net(curve.params, tiny_net(), per_channel=False)
    jqn = jquant.quantize_net(jparams, jsn.tiny_net(), per_channel=False)
    counts = []
    pol = dict(fusion_policy="per-step")       # the oracle lowering
    for eng, mod, spec in (
            (EventServeEngine(qn.spec, qn.params_for("f32-carrier"), 6,
                              window=16, device="cpu",
                              policy=ExecutionPolicy(**pol)), ds, qn.spec),
            (jserve.EventServeEngine(jqn.spec, jqn.params_for("f32-carrier"),
                                     6, window=16, use_pallas=False,
                                     policy=jpol.ExecutionPolicy(**pol)),
             jds, jqn.spec)):
        reqs = mod.segment_recording(
            mod.load_recording(mod.sample_recording_path()), spec.in_shape,
            spec.n_timesteps, WINDOW_US)
        eng.run(reqs)
        counts.append(np.stack([np.asarray(r.class_counts) for r in reqs]))
    np.testing.assert_array_equal(counts[0], counts[1])
    assert counts[0].sum() > 0


# ---------------------------------------------------------------------------
# On the card (gpu marker; skipped without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


class _DenseOps(TorchDispatchMode):
    """Records every convolution (forward and backward) with the cuDNN
    flags in force, and every device a tensor argument of an operation
    lay on (host transfers and views aside)."""

    TRANSFERS = ("_to_copy", "copy_", "lift_fresh", "_local_scalar_dense",
                 "detach", "alias")

    def __init__(self):
        super().__init__()
        self.convs, self.devices = [], set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).split(".")[1] not in self.TRANSFERS:
            self.devices |= {a.device.type for a in args
                             if isinstance(a, torch.Tensor)}
        if "convolution" in str(func):
            b = torch.backends.cudnn
            self.convs.append((str(func), b.enabled, b.allow_tf32,
                               b.deterministic, b.benchmark))
        return func(*args, **(kwargs or {}))


@pytest.mark.gpu
@pytest.mark.parametrize("qat", [False, True])
def test_cuda_step_matches_cpu(cuda, qat):
    """One step on the card and on the CPU from dyadic weights: every
    layer's spikes bitwise, gradients at rtol 1e-4 / atol 1e-6; every op
    on the card, every convolution in ``dense_math``'s scope (cuDNN off,
    TF32 off, deterministic)."""
    rng = np.random.default_rng(11)
    spec = tiny_net(T)
    arrays = _dyadic(rng, spec)
    x = _spikes(rng, 2, spec)
    out = {}
    for dev in ("cpu", cuda):
        program = compile_program(spec, device=dev)
        leaves = [_t(a).to(dev).requires_grad_() for a in arrays]
        xd = _t(x).to(dev)
        spy = _DenseOps()
        with spy:
            with dense_math():
                _, acts = dense_program_forward(
                    program, [EConvParams(w=w) for w in leaves], xd,
                    train=True, qat=qat)
                loss = sum(a.sum() for a in acts)
                grads = torch.autograd.grad(loss, leaves)
        out[str(dev)] = ([a.detach().cpu() for a in acts],
                         [g.cpu() for g in grads], spy)
    (ca, cg, _), (ga, gg, spy) = out["cpu"], out[str(cuda)]
    for a, b in zip(ca, ga):
        assert torch.equal(a, b)
    for a, b in zip(cg, gg):
        _close(b, a, 1e-4, 1e-6)
    assert spy.devices == {"cuda"}
    kinds = {c[0] for c in spy.convs}
    assert any("backward" in k for k in kinds), kinds
    assert all(c[1:] == (False, False, True, False) for c in spy.convs)


@pytest.mark.gpu
def test_cuda_fit_resumes_bitwise_and_serves(cuda, tmp_path):
    """fit on the card: resume from step 3 bitwise; the trained net,
    quantised, served under every lowering and both dtype policies with
    equal class counts, equal to the card's dense forward where nothing
    dropped."""
    import shutil
    spec = tiny_net()
    cfg = loop.TrainConfig(steps=6, batch=4, qat=True)
    first = loop.fit(spec, ds.TINY, cfg, ckpt_dir=str(tmp_path),
                     ckpt_every=3, device=cuda, log_fn=lambda s: None)
    shutil.rmtree(tmp_path / "step_00000006")
    second = loop.fit(spec, ds.TINY, cfg, ckpt_dir=str(tmp_path),
                      ckpt_every=3, device=cuda, log_fn=lambda s: None)
    assert second.start_step == 3
    np.testing.assert_array_equal(second.losses, first.losses[3:])
    for a, b in zip(first.params, second.params):
        assert a.w.device.type == "cuda" and torch.equal(a.w, b.w)
    qn = quant.quantize_net(first.params, spec, per_channel=False)
    x, _ = ds.batch_at(1, 10 ** 6, 4, ds.TINY, device=cuda)
    want = dense_apply(qn.params_for("f32-carrier"), qn.spec, x)[0]
    want = want.sum(1).flatten(1).cpu().numpy()
    for dp in ("f32-carrier", "int8-native"):
        for fusion in ("fused-window", "fused-network", "per-step"):
            from repro_torch.serve.event_engine import EventRequest
            reqs = [EventRequest.from_dense(i, x[i].cpu()) for i in range(4)]
            EventServeEngine(qn.spec, qn.params_for(dp), 4, window=4,
                             device=cuda, policy=ExecutionPolicy(
                                 dtype_policy=dp, fusion_policy=fusion)
                             ).run(reqs)
            for i, r in enumerate(reqs):
                t = r.telemetry
                if t.input_dropped == 0 and sum(t.inter_layer_dropped) == 0:
                    np.testing.assert_array_equal(
                        np.asarray(r.class_counts), want[i],
                        err_msg=f"{dp} {fusion} request {i}")
