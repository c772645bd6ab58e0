"""The port's LM serving path against the JAX reference, on the CPU.

The reference's parameters (``repro.models.transformer.init_model`` from
``PRNGKey(0)``) cross over as numpy through
``repro_torch.weights.lm_params_from_numpy``; inputs are drawn with numpy.

Tolerances (float32 smoke configs):

* ``F32``: ``|port - ref| <= 1e-5 + 1e-5 * |ref|`` for every module, the
  logits of ``forward``, ``prefill`` and ``decode_step``, and every cache
  leaf.  The two packages run the same operations in the same order, but
  their matmuls, ``pow`` and softmax kernels round differently (the
  largest difference seen is 4.4e-6 on a cache leaf, 2.6e-6 on logits of
  magnitude up to 4.5).  ``linear_scan`` pairs elements in another order
  than ``jax.lax.associative_scan`` and stays inside the same bound
  (4.8e-7 at S = 300, values up to 3.2).
* Greedy and temperature tokens are compared wherever the reference's
  top-2 margin (of the logits, or of ``logits / T + g``) exceeds twice
  the logits' tolerance; the engine comparison is teacher-forced, the
  port taking the reference's token at every sampling call.
* ``BF16``: one bfloat16 case (3 layers), ``|port - ref| <= 4 * 2^-8 *
  sqrt(2 L) * max(1, max |ref|)``: two bfloat16 runs that round in other
  places drift apart like a random walk over the 2L residual adds of L
  layers, and the bound is four standard deviations of it at the logits'
  scale (0.038 here; measured 0.019).  ``chip_smoke.py`` holds the
  full-width decode to the same rule.

The ``gpu`` test (skipped without a card) serves the smoke engine on the
card and on the CPU; it imports no JAX and runs with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_lm.py
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.core import lm_events as tev
from repro_torch.core import sd_decode as tsd
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import recurrent as TR
from repro_torch.models import transformer as T
from repro_torch.models.frontend import frontend_feature_shape
from repro_torch.models.layers import tree_leaves
from repro_torch.serve import Request, ServeEngine
from repro_torch.weights import lm_cache_from_numpy, lm_params_from_numpy

torch.set_num_threads(1)
F32 = dict(rtol=1e-5, atol=1e-5)
ARCHS = tcfg.ARCH_IDS


class _Lazy:
    """A module of the reference, imported on first use: the card's
    machine has no JAX, and the gpu test never touches one."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


jax, jnp = _Lazy("jax"), _Lazy("jax.numpy")
JT, JA = _Lazy("repro.models.transformer"), _Lazy("repro.models.attention")
JL, JR = _Lazy("repro.models.layers"), _Lazy("repro.models.recurrent")
JSD, JEV = _Lazy("repro.core.sd_decode"), _Lazy("repro.core.lm_events")
JCFG, JENG = _Lazy("repro.configs"), _Lazy("repro.serve.engine")


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return np.asarray(x.detach().float().cpu().numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32))


def _close(got, want, tol=F32, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(seed, decls):
    """A reference sub-tree from ``init_tree`` and its port twin."""
    p = JL.init_tree(jax.random.PRNGKey(seed), decls)
    return p, {k: _t(v) for k, v in p.items()}


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# Configs and parameters
# ---------------------------------------------------------------------------

def test_registry_and_configs_match_the_reference():
    assert tcfg.ARCH_IDS == JCFG.ARCH_IDS
    for arch in ARCHS:
        for got, want in ((tcfg.get_config(arch), JCFG.get_config(arch)),
                          (tcfg.get_smoke(arch), JCFG.get_smoke(arch))):
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert [([dataclasses.astuple(s) for s in specs], n)
                    for specs, n in got.scan_groups()] == [
                ([dataclasses.astuple(s) for s in specs], n)
                for specs, n in want.scan_groups()]
            assert T.param_count(got) == JT.param_count(want)
    with pytest.raises(KeyError):
        tcfg.get_config("nope")


def test_unported_layer_kinds_are_refused():
    """Nothing is refused any more: the shard-map MoE config builds its
    parameters and caches and runs (the gather path without a mesh, as in
    the reference), ``flash_attention(fold=True)`` and ``causal_fold``
    run (bitwise the plain schedule), and int8 storage keeps the
    parameter count."""
    cfg = dataclasses.replace(tcfg.get_smoke("olmoe-1b-7b"),
                              moe_impl="shardmap")
    p = T.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    assert len(T.cache_decls(cfg, 1, 8)) == cfg.n_layers
    toks = torch.zeros((1, 8), dtype=torch.long)
    h, _, _ = T.forward(p, cfg, toks)
    gather = dataclasses.replace(cfg, moe_impl="gather")
    assert torch.equal(h, T.forward(p, gather, toks)[0])
    q = torch.randn((1, 8, 2, 8), generator=torch.Generator().manual_seed(1))
    assert torch.equal(TA.flash_attention(q, q, q, causal=True, chunk_q=4,
                                          chunk_kv=4, fold=True),
                       TA.flash_attention(q, q, q, causal=True, chunk_q=4,
                                          chunk_kv=4))
    granite = tcfg.get_smoke("granite-8b")        # chunk 64: Nq = 2
    gp = T.init_model(torch.Generator().manual_seed(2), granite, "cpu")
    toks = torch.arange(128)[None] % granite.vocab_size
    folded = dataclasses.replace(granite, causal_fold=True)
    assert torch.equal(T.forward(gp, folded, toks)[0],
                       T.forward(gp, granite, toks)[0])
    int8 = dataclasses.replace(tcfg.get_smoke("granite-8b"),
                               weight_quant="int8")
    assert T.param_count(int8) == T.param_count(tcfg.get_smoke("granite-8b"))


def test_init_model_draws_the_declared_tree():
    cfg = tcfg.get_smoke("recurrentgemma-2b")
    p = T.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    q = T.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    leaves = dict(tree_leaves(p))
    decls = dict(tree_leaves(T.model_decls(cfg)))
    assert set(leaves) == set(decls)
    for path, d in decls.items():
        w = leaves[path]
        assert tuple(w.shape) == d.shape and w.dtype == torch.float32
        if d.init == "normal":
            std = d.scale if d.scale is not None else d.fan_in() ** -0.5
            assert float(w.abs().max()) <= 2 * std * (1 + 1e-6)
            if w.numel() >= 4096:
                assert 0.7 * std < float(w.std()) < 1.0 * std
        else:
            assert torch.all(w == (0.0 if d.init == "zeros" else 1.0))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves(p), tree_leaves(q)))
    assert sum(w.numel() for w in leaves.values()) == T.param_count(cfg)


def test_weight_converter_checks_shapes_and_keys():
    cfg = tcfg.get_smoke("granite-8b")
    tree = _tree_np(JT.init_model(jax.random.PRNGKey(0),
                                  JCFG.get_smoke("granite-8b")))
    p = lm_params_from_numpy(tree, cfg, "cpu")
    g = tree["groups"]["g0"]["l0"]
    np.testing.assert_array_equal(p["layers"][2]["attn"]["wq"].numpy(),
                                  g["attn"]["wq"][2])
    bad = dict(tree, embed=tree["embed"][:, :-1])
    with pytest.raises(ValueError, match="embed: shape"):
        lm_params_from_numpy(bad, cfg, "cpu")
    bad = dict(tree, extra=np.zeros(3))
    with pytest.raises(ValueError, match="unexpected"):
        lm_params_from_numpy(bad, cfg, "cpu")


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_rms_norm_rope_and_ffn(act):
    rng = np.random.default_rng(1)
    x = _randn(rng, 2, 6, 3, 16)
    w = _randn(rng, 16, scale=0.1)
    _close(TL.rms_norm(_t(x), _t(w), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    pos = rng.integers(0, 5000, size=(2, 6))
    _close(TL.rope(_t(x), _t(pos), 10000.0),
           JL.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    jp, tp = _params(2, JL.ffn_decls(16, 40))
    xf = _randn(rng, 2, 5, 16, scale=2.0)
    _close(TL.ffn_apply(tp, _t(xf), act), JL.ffn_apply(jp, jnp.asarray(xf),
                                                       act))


@pytest.mark.parametrize("causal,window,Sq,Skv,H,Hk,chunk", [
    (True, 0, 16, 16, 4, 4, 8),        # causal, MHA
    (True, 5, 24, 24, 4, 2, 8),        # sliding window, GQA
    (True, 0, 13, 13, 4, 1, 8),        # padded chunks, MQA
    (False, 0, 10, 21, 6, 2, 8),       # not causal, padded, GQA
])
def test_flash_attention(causal, window, Sq, Skv, H, Hk, chunk):
    rng = np.random.default_rng(3)
    q = _randn(rng, 2, Sq, H, 16)
    k, v = _randn(rng, 2, Skv, Hk, 16), _randn(rng, 2, Skv, Hk, 16)
    got = TA.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             window=window, chunk_q=chunk, chunk_kv=chunk)
    want = JA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, chunk_q=chunk,
                              chunk_kv=chunk)
    _close(got, want)


def test_decode_attention_and_cache_insert():
    rng = np.random.default_rng(4)
    q = _randn(rng, 3, 1, 4, 8)
    k, v = _randn(rng, 3, 12, 2, 8), _randn(rng, 3, 12, 2, 8)
    for pos, window in ((7, 0), (np.array([0, 5, 11]), 0),
                        (np.array([3, 9, 11]), 4)):
        got = TA.decode_attention(_t(q), _t(k), _t(v), _t(pos),
                                  window=window)
        want = JA.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(pos),
                                   window=window)
        _close(got, want)
    new = _randn(rng, 3, 1, 2, 8)
    for pos in (0, 5, 11, 15):
        got = TA.cache_insert(_t(k), _t(new), pos)
        want = JA.cache_insert(jnp.asarray(k), jnp.asarray(new), pos)
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_conv1d_and_rglru_scan_and_step():
    rng = np.random.default_rng(5)
    jp, tp = _params(6, JR.rglru_decls(16, 16, 4))
    x = _randn(rng, 2, 11, 16)
    w, b = _randn(rng, 4, 16), _randn(rng, 16)
    _close(TR.conv1d_causal(_t(x), _t(w), _t(b)),
           JR.conv1d_causal(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    xc, h0 = _randn(rng, 2, 300, 16), _randn(rng, 2, 16)
    jscan = jax.jit(JR.rglru_scan)
    for h in (None, h0):
        got = TR.rglru_scan(tp, _t(xc), None if h is None else _t(h))
        want = jscan(jp, jnp.asarray(xc),
                     None if h is None else jnp.asarray(h))
        for g, w_ in zip(got, want):
            _close(g, w_)
    xb = _randn(rng, 2, 9, 16)
    out, st = TR.rglru_block(tp, _t(xb))
    jout, jst = JR.rglru_block(jp, jnp.asarray(xb), None)
    _close(out, jout)
    _close(st["h"], jst["h"])
    _close(st["conv"], jst["conv"])
    x1 = _randn(rng, 2, 1, 16)
    out, st2 = TR.rglru_block_step(tp, _t(x1), st)
    jout, jst2 = JR.rglru_block_step(jp, jnp.asarray(x1), jst, None)
    _close(out, jout)
    for key in ("h", "conv"):
        _close(st2[key], jst2[key])


@pytest.mark.parametrize("frac", [1.0, 0.25])
def test_sd_matvec_and_pair(frac):
    rng = np.random.default_rng(7)
    d_in, d_out, B = 64, 24, 2
    w1, w2 = _randn(rng, d_in, d_out), _randn(rng, d_in, d_out)
    cap = tsd.sd_cap(d_in, frac)
    assert cap == JSD.sd_cap(d_in, frac)
    x_ref, y_ref = np.zeros((B, d_in), np.float32), np.zeros((B, d_out),
                                                              np.float32)
    st_t = (_t(x_ref), _t(y_ref), _t(y_ref))
    st_j = tuple(jnp.asarray(a) for a in (x_ref, y_ref, y_ref))
    base = _randn(rng, B, d_in)
    for _ in range(4):
        x = base + _randn(rng, B, d_in, scale=0.05)
        got = tsd.sd_matvec_pair(_t(w1), _t(w2), _t(x), *st_t, cap)
        want = JSD.sd_matvec_pair(jnp.asarray(w1), jnp.asarray(w2),
                                  jnp.asarray(x), *st_j, cap)
        for g, w_ in zip(got, want):
            _close(g, w_)
        st_t, st_j = got[2:], want[2:]
        if frac == 1.0:     # full capacity: the product, to rounding
            _close(got[0], x @ w1, dict(rtol=1e-4, atol=1e-4))
    y, xr, yr = tsd.sd_matvec(_t(w1), _t(x), st_t[0], st_t[1], cap)
    jy, jxr, jyr = JSD.sd_matvec(jnp.asarray(w1), jnp.asarray(x), st_j[0],
                                 st_j[1], cap)
    for g, w_ in ((y, jy), (xr, jxr), (yr, jyr)):
        _close(g, w_)
    assert tsd.read_bytes_per_layer(2560, 2560, 7680, frac) \
        == JSD.read_bytes_per_layer(2560, 2560, 7680, frac)


def test_lm_events():
    rng = np.random.default_rng(8)
    x = _randn(rng, 2, 8)
    ref = _randn(rng, 2, 8, scale=0.5)
    for th in (0.0, 0.3):
        got = tev.sd_encode(tev.SigmaDelta(_t(ref)), _t(x), th)
        want = JEV.sd_encode(JEV.SigmaDelta(jnp.asarray(ref)),
                             jnp.asarray(x), th)
        np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
        np.testing.assert_array_equal(_np(got[1].ref),
                                      np.asarray(want[1].ref))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert float(tev.sd_event_rate(got[2])) == float(
            JEV.sd_event_rate(want[2]))
        assert int(tev.activation_events(_t(x), th)) == int(
            JEV.activation_events(jnp.asarray(x), th))
    jp, tp = _params(9, JR.rglru_decls(8, 8, 4))
    h = _randn(rng, 2, 8)
    got = tev.gated_rglru_step(tp, _t(x), _t(h), tev.sd_init(_t(x)), 0.3)
    want = JEV.gated_rglru_step(jp, jnp.asarray(x), jnp.asarray(h),
                                JEV.sd_init(jnp.asarray(x)), 0.3)
    for g, w_ in zip((got[0], got[1], got[2].ref, got[3]),
                     (want[0], want[1], want[2].ref, want[3])):
        _close(g, w_)
    assert tev.decode_energy_estimate(0.1, 256, 4, 100) \
        == JEV.decode_energy_estimate(0.1, 256, 4, 100)


# The reference's own checks (tests/test_recurrent_blocks.py,
# tests/test_perf_variants.py), repeated on the port.

def test_port_scan_equals_stepwise_and_prefill_state_matches_decode():
    rng = np.random.default_rng(0)
    _, p = _params(0, JR.rglru_decls(8, 8, 4))
    xc = _t(_randn(rng, 2, 12, 8))
    h_seq, h_last = TR.rglru_scan(p, xc)
    h = torch.zeros((2, 8))
    outs = []
    for t in range(12):
        o, h = TR.rglru_step(p, xc[:, t], h)
        outs.append(o)
    torch.testing.assert_close(h_seq, torch.stack(outs, 1), rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(h_last, h, rtol=1e-4, atol=1e-5)
    x = _t(_randn(rng, 1, 10, 8))
    out_full, _ = TR.rglru_block(p, x)
    _, st_pre = TR.rglru_block(p, x[:, :9])
    out_step, _ = TR.rglru_block_step(p, x[:, 9:10], st_pre)
    torch.testing.assert_close(out_full[:, 9:10], out_step, rtol=1e-4,
                               atol=1e-5)
    y = TR.conv1d_causal(torch.zeros((1, 8, 4)).index_fill_(1, torch.tensor(
        [3]), 1.0), torch.ones((4, 4)), torch.zeros(4))
    assert float(y[0, :3].abs().sum()) == 0.0 and float(y[0, 3].abs().sum())


def test_port_sd_decode_full_capacity_exact_partial_bounded():
    cfg = tcfg.get_smoke("recurrentgemma-2b")
    params = T.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(1, 10)))
    cfg_sd = dataclasses.replace(cfg, sd_decode_frac=1.0)
    c_sd, c_ex = T.init_cache(cfg_sd, 1, 24, "cpu"), T.init_cache(cfg, 1, 24,
                                                                   "cpu")
    for t in range(10):
        l1, c_sd, _ = T.decode_step(params, cfg_sd, c_sd, toks[:, t:t + 1], t)
        l2, c_ex, _ = T.decode_step(params, cfg, c_ex, toks[:, t:t + 1], t)
        torch.testing.assert_close(l1, l2, rtol=0, atol=1e-3)
    rng = np.random.default_rng(0)
    w = _t(_randn(rng, 64, 32))
    x_ref, y_ref = torch.zeros((1, 64)), torch.zeros((1, 32))
    base = _randn(rng, 1, 64)
    cap = tsd.sd_cap(64, 0.25)
    errs = []
    for _ in range(20):
        x = _t(base + _randn(rng, 1, 64, scale=0.05))
        y, x_ref, y_ref = tsd.sd_matvec(w, x, x_ref, y_ref, cap)
        errs.append(float((y - x @ w).abs().max()))
    assert max(errs[10:]) <= max(errs[:10]) * 3 + 1e-3
    assert np.isfinite(errs).all()


def test_port_sigma_delta_gating():
    x = _t(np.random.default_rng(4).normal(size=(2, 8)).astype(np.float32))
    x_eff, _, fires = tev.sd_encode(tev.sd_init(x), x, threshold=0.0)
    assert torch.equal(x_eff, x) and bool(fires.all())
    sd = tev.sd_init(torch.zeros(4))
    x1 = torch.tensor([1.0, 0.05, 0.0, -2.0])
    x_eff, sd, f1 = tev.sd_encode(sd, x1, threshold=0.1)
    assert f1.tolist() == [True, False, False, True]
    assert x_eff.tolist() == [1.0, 0.0, 0.0, -2.0]
    _, sd, f2 = tev.sd_encode(sd, x1 + 0.01, threshold=0.1)
    assert not bool(f2.any())
    e1 = tev.decode_energy_estimate(0.1, 256, 4, 100)
    e2 = tev.decode_energy_estimate(0.2, 256, 4, 100)
    assert e2["energy_j"] == pytest.approx(2 * e1["energy_j"])


# ---------------------------------------------------------------------------
# The decoder stack, per arch
# ---------------------------------------------------------------------------

_MODELS = {}


def _model(arch, dtype="float32"):
    """(reference cfg, reference params, port cfg, port params), cached."""
    key = (arch, dtype)
    if key not in _MODELS:
        jc = dataclasses.replace(JCFG.get_smoke(arch), dtype=dtype)
        cfg = dataclasses.replace(tcfg.get_smoke(arch), dtype=dtype)
        jp = JT.init_model(jax.random.PRNGKey(0), jc)
        _MODELS[key] = (jc, jp, cfg,
                        lm_params_from_numpy(_tree_np(jp), cfg, "cpu"))
    return _MODELS[key]


def _check_cache(got, jcache, cfg, S, tol=F32):
    want = lm_cache_from_numpy(_tree_np(jcache), cfg, S, "cpu")
    for (path, g), (_, w) in zip(tree_leaves(got), tree_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        _close(g, w, tol, what=str(path))


def _stub(cfg, B, seed):
    """The stub frontend's inputs (``frames`` or ``patches``) as numpy,
    or none."""
    shape = frontend_feature_shape(cfg, B)
    if shape is None:
        return {}
    key = "frames" if cfg.frontend == "audio" else "patches"
    return {key: _randn(np.random.default_rng(seed), *shape)}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch):
    """forward logits and MoE stats; prefill logits and every cache leaf;
    8 decode steps, logits and caches.  A 20-token prompt wraps the smoke
    window of 16 in the local-attention rings (gemma3, recurrentgemma);
    whisper's encoder takes 32 stub frames, internvl2's first 8 positions
    are stub patches.  Decode is held to the forward's logits too where
    the published capacity drops no route (not for MoE: the prefill of 40
    tokens drops where the forward of 56 does not, or other ones)."""
    jc, jp, cfg, p = _model(arch)
    P, S = 20, 28
    toks = np.random.default_rng(10).integers(0, cfg.vocab_size, (2, S))
    stub = _stub(cfg, 2, 14)
    jstub = {k: jnp.asarray(v) for k, v in stub.items()}
    tstub = {k: _t(v) for k, v in stub.items()}

    def jfwd(pp, t, kw):
        x, st, _ = JT.forward(pp, jc, t, **kw)
        return JT._unembed(pp, jc, x), st
    full, jst = jax.jit(jfwd)(jp, jnp.asarray(toks), jstub)
    x, st, _ = T.forward(p, cfg, _t(toks), **tstub)
    _close(T.unembed(p, cfg, x), full)
    _close(st.aux_loss, jst.aux_loss, what="aux_loss")
    _close(st.dropped_frac, jst.dropped_frac, what="dropped_frac")
    if cfg.n_experts:
        assert float(st.aux_loss) > 0

    jlog, jcache, jpos = jax.jit(lambda pp, t, kw: JT.prefill(
        pp, jc, t, cache_len=S, **kw))(jp, jnp.asarray(toks[:, :P]), jstub)
    log, cache, pos = T.prefill(p, cfg, _t(toks[:, :P]), cache_len=S,
                                **tstub)
    assert pos == int(jpos) == P - 1
    _close(log, jlog)
    _check_cache(cache, jcache, cfg, S)
    jdec = jax.jit(lambda pp, c, t, q: JT.decode_step(pp, jc, c, t, q))
    for t in range(P, S):
        jlog, jcache, _ = jdec(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                               jnp.int32(t))
        log, cache, nxt = T.decode_step(p, cfg, cache, _t(toks[:, t:t + 1]),
                                        t)
        _close(log, jlog, what=f"step {t}")
        if not cfg.n_experts:
            _close(log[:, 0], full[:, t], dict(rtol=0, atol=5e-4))
        assert nxt.tolist() == [t + 1, t + 1]
    _check_cache(cache, jcache, cfg, S)


def test_bf16_forward_and_decode():
    jc, jp, cfg, p = _model("recurrentgemma-2b", "bfloat16")
    assert all(w.dtype == torch.bfloat16 for _, w in tree_leaves(p))
    toks = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 24))
    full = np.asarray(jax.jit(lambda pp, t: JT._unembed(
        pp, jc, JT.forward(pp, jc, t)[0]))(jp, jnp.asarray(toks)), np.float32)
    tol = dict(rtol=0, atol=4 * 2 ** -8 * (2 * cfg.n_layers) ** 0.5
               * max(1.0, np.abs(full).max()))
    x, _, _ = T.forward(p, cfg, _t(toks))
    _close(T.unembed(p, cfg, x), full, tol)
    jlog, jcache, _ = jax.jit(lambda pp, t: JT.prefill(
        pp, jc, t, cache_len=24))(jp, jnp.asarray(toks[:, :16]))
    log, cache, _ = T.prefill(p, cfg, _t(toks[:, :16]), cache_len=24)
    _close(log, jlog, tol)
    jdec = jax.jit(lambda pp, c, t, q: JT.decode_step(pp, jc, c, t, q))
    for t in range(16, 20):
        jlog, jcache, _ = jdec(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                               jnp.int32(t))
        log, cache, _ = T.decode_step(p, cfg, cache, _t(toks[:, t:t + 1]), t)
        assert log.dtype == torch.bfloat16
        _close(log, jlog, tol)


def test_short_prompt_is_refused():
    _, _, cfg, p = _model("recurrentgemma-2b")
    with pytest.raises(ValueError, match="at least 3"):
        T.prefill(p, cfg, torch.zeros((1, 2), dtype=torch.long),
                  cache_len=8)
    eng = ServeEngine(cfg, p, batch_slots=1, cache_len=8, device="cpu")
    with pytest.raises(ValueError, match="at least 3"):
        eng.try_admit(Request(0, np.array([5, 6]), 4))
    with pytest.raises(ValueError, match="no room"):
        eng.try_admit(Request(1, np.arange(8), 4))
    assert T.prefill(p, cfg, torch.zeros((1, 3), dtype=torch.long))[2] == 2


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

PROMPT_LENS = (4, 20, 11, 4, 20)
# a 20-token prompt reaches the cache's end (pos >= S - 1) before its 6
# tokens; the 4- and 11-token prompts leave ring slots unwritten
ENGINE_CACHE = 24


def _requests(cfg, seed):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(2, cfg.vocab_size, size=n), 6)
            for i, n in enumerate(PROMPT_LENS)]


def _record(eng, forced=None):
    """Record every sampling call's logits and choice on ``eng``; with
    ``forced`` (a list of tokens), return those instead of the engine's
    own choices (teacher forcing)."""
    seen = []
    own = eng._sample

    def sample(logits):
        choice = int(own(logits))
        seen.append((np.array(logits[:eng.cfg.vocab_size], np.float32),
                     choice))
        return forced[len(seen) - 1] if forced is not None else choice
    eng._sample = sample
    return seen


def _margins(logits, temperature, noise):
    z = logits if temperature <= 0 else logits / np.float32(temperature) \
        + noise
    top = np.sort(z)[-2:]
    return float(top[1] - top[0])


def _serve_both(arch, temperature, jeng_jits):
    jc, jp, cfg, p = _model(arch)
    noise = np.random.default_rng(12).gumbel(
        size=(64, cfg.vocab_size)).astype(np.float32)
    jeng = JENG.ServeEngine(jc, jp, batch_slots=2, cache_len=ENGINE_CACHE,
                            temperature=temperature)
    if jeng_jits:   # the same params and shapes: reuse the compiled steps
        jeng._prefill, jeng._decode = jeng_jits
    calls = {"j": 0}

    def categorical(key, z):
        calls["j"] += 1
        return jnp.argmax(z + noise[calls["j"] - 1])
    jseen = _record(jeng)
    jreqs = _requests(cfg, 13)
    real = jax.random.categorical
    jax.random.categorical = categorical
    try:
        jeng.run(jreqs)
    finally:
        jax.random.categorical = real
    eng = ServeEngine(cfg, p, batch_slots=2, cache_len=ENGINE_CACHE,
                      temperature=temperature, device="cpu")
    tcalls = iter(range(len(noise)))
    eng.gumbel = lambda shape: noise[next(tcalls)]
    seen = _record(eng, forced=[c for _, c in jseen])
    reqs = _requests(cfg, 13)
    eng.run(reqs)
    assert len(seen) == len(jseen) == sum(len(r.out_tokens) for r in jreqs)
    n_checked = 0
    for k, ((lg, mine), (jlg, theirs)) in enumerate(zip(seen, jseen)):
        _close(lg, jlg, what=f"sampling call {k}")
        err = F32["atol"] + F32["rtol"] * np.abs(jlg).max()
        if temperature > 0:
            err /= temperature
        if _margins(jlg, temperature, noise[k]) > 2 * err:
            assert mine == theirs, k
            n_checked += 1
    assert n_checked > 0.8 * len(seen)
    assert eng.stats == jeng.stats
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in jreqs]
    assert all(r.done for r in reqs)
    assert min(len(r.out_tokens) for r in reqs) < 6    # the cache-end rule
    return jeng._prefill, jeng._decode


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "granite-8b",
                                  "olmoe-1b-7b", "llama4-maverick-400b-a17b",
                                  "xlstm-1.3b"])
def test_engine_matches_reference_engine(arch):
    """5 requests (prompts of 4-20 tokens) on 2 slots, greedy and then
    with temperature 0.7 on shared Gumbel noise: teacher-forced logits per
    sampling call within F32, the port's own token equal to the reference's
    wherever the margin allows, equal stats."""
    jits = _serve_both(arch, 0.0, None)
    _serve_both(arch, 0.7, jits)


def test_launcher_serves_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "recurrentgemma-2b", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--max-tokens", "4",
                "--cache-len", "32"])
    out = capsys.readouterr().out
    assert out.startswith("[serve] 3 requests, ") and "on cpu" in out


# ---------------------------------------------------------------------------
# On the card (gpu marker; skipped without one)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "olmoe-1b-7b",
                                  "xlstm-1.3b"])
def test_cuda_engine_matches_cpu(arch):
    """A smoke engine (float32, TF32 off) on the card and on the CPU from
    the same weights: teacher-forced logits within 1e-4, tokens equal
    wherever the CPU's margin exceeds 2e-4, equal stats."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = tcfg.get_smoke(arch)
    p = T.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    pc = TL.tree_map(lambda w: w.to("cuda"), p)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = []
        for dev, params in (("cpu", p), ("cuda", pc)):
            eng = ServeEngine(cfg, params, batch_slots=2, cache_len=32,
                              device=dev)
            seen = _record(eng, forced=None if not runs else
                           [c for _, c in runs[0][1]])
            eng.run(_requests(cfg, 13))
            runs.append((eng, seen))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    (ce, cs), (ge, gs) = runs
    assert len(cs) == len(gs) and ce.stats == ge.stats
    for (glg, mine), (clg, theirs) in zip(gs, cs):
        _close(glg, clg, dict(rtol=0, atol=1e-4))
        if _margins(clg, 0.0, None) > 2e-4:
            assert mine == theirs
