"""The port's MoE, xLSTM, int8 storage, sinusoidal positions and stub
frontends against the JAX reference, on the CPU.

Weights come from the reference's initialisers and cross over as numpy;
inputs are drawn with numpy.  Tolerances:

* ``F32``: ``|port - ref| <= 1e-5 + 1e-5 * |ref|`` (the rule of
  ``tests/test_torch_lm.py``): the same operations in the same order,
  rounded by other matmul, ``exp`` and softmax kernels.
* Exact: which (expert, token) routes an expert keeps, ``dropped_frac``,
  ``_capacity``, ``active_param_count``, and the int8 codes and scales
  (both packages divide in float32, correctly rounded, and round half to
  even).  The kept routes of the reference are read with its own
  ``jax.lax.top_k`` on its own router math (``_ref_kept``), since
  ``moe_apply`` returns only the combined output.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import frontend as JF
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import quant_lm as JQ
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro_torch import configs as tcfg
from repro_torch.models import frontend as TF
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import quant_lm as TQ
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as TX
from repro_torch.models.layers import tree_leaves
from repro_torch.serve import Request, ServeEngine
from repro_torch.weights import lm_params_from_numpy

torch.set_num_threads(1)
F32 = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(np.asarray(x), np.float32)


def _close(got, want, tol=F32, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def _params(seed, decls):
    """A reference sub-tree from ``init_tree`` and its port twin."""
    p = JL.init_tree(jax.random.PRNGKey(seed), decls)
    return p, _to_torch(jax.tree.map(np.asarray, p))


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def test_capacity_matches_reference():
    for n in (1, 2, 4, 7, 8, 40, 56, 100, 1500, 4096):
        for e in (4, 64, 128):
            for k in (1, 2, 8):
                for f in (0.25, 1.0, 1.25, 2.0, 8.0):
                    assert TM._capacity(n, e, k, f) == JM._capacity(
                        n, e, k, f), (n, e, k, f)


def _ref_kept(jp, x, top_k, capacity):
    """The reference's kept (expert, token) routes: its router math and
    its two ``jax.lax.top_k`` choices (``repro/models/moe.py:72-84``)."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    logits = jnp.einsum("td,de->te", xf, jp["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_i = jax.lax.top_k(probs, top_k)
    top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    sel = jnp.zeros(probs.shape, jnp.float32).at[
        jnp.arange(xf.shape[0])[:, None], top_i].set(top_p)
    gate, idx = jax.lax.top_k(jnp.where(sel.T > 0, sel.T, -1.0), capacity)
    idx = np.asarray(idx)
    return {(int(e), int(idx[e, c]))
            for e, c in zip(*np.nonzero(np.asarray(gate) > 0))}


@pytest.mark.parametrize("top_k,shared,factor", [
    (1, True, 0.25),      # llama4's form: every gate 1.0, overflow = ties
    (1, False, 8.0),      # ample
    (2, False, 0.5),      # overflow
    (2, True, 0.5),       # overflow, shared expert
    (2, False, 8.0),      # ample
])
def test_moe_apply_matches_reference(top_k, shared, factor):
    """48 tokens over 4 experts: the output and aux_loss within F32, the
    kept (expert, token) routes and dropped_frac exactly."""
    E, d, f = 4, 32, 48
    jp, tp = _params(top_k + 2 * shared, JM.moe_decls(d, E, f, shared, 40))
    x = _randn(np.random.default_rng(20 + top_k), 2, 24, d)
    kw = dict(n_experts=E, top_k=top_k, capacity_factor=factor, act="silu",
              shared=shared)
    out, st = TM.moe_apply(tp, torch.as_tensor(x), **kw)
    jout, jst = JM.moe_apply(jp, jnp.asarray(x), **kw)
    _close(out, jout)
    _close(st.aux_loss, jst.aux_loss)
    assert float(st.dropped_frac) == float(jst.dropped_frac)

    C = TM._capacity(48, E, top_k, factor)
    _, sel = TM.route(tp["router"], torch.as_tensor(x).reshape(48, d), top_k)
    gate, idx, valid = TM.dispatch(sel, C)
    kept = {(e, int(idx[e, c])) for e, c in valid.nonzero().tolist()}
    assert kept == _ref_kept(jp, x, top_k, C)
    routes = int((sel > 0).sum())
    assert float(st.dropped_frac) == np.float32(1.0) - np.float32(
        len(kept)) / np.float32(routes)
    if factor < 1:
        assert len(kept) < routes           # the case overflows
    if top_k == 1:
        # all ties: on overflow an expert keeps its lowest token indices
        assert torch.all(gate[valid > 0] == 1.0)
        for e in range(E):
            mine = sorted(t for ee, t in kept if ee == e)
            routed = sel[:, e].nonzero()[:, 0].tolist()
            assert mine == routed[:C]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b",
                                  "llama4-maverick-400b-a17b"])
def test_active_param_count_matches_reference(arch):
    for get, jget in ((tcfg.get_config, jget_config),
                      (tcfg.get_smoke, jget_smoke)):
        assert T.active_param_count(get(arch)) == JT.active_param_count(
            jget(arch))
    assert T.active_param_count(tcfg.get_smoke("granite-8b")) == \
        T.param_count(tcfg.get_smoke("granite-8b"))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_decode_matches_forward_at_relaxed_capacity(arch):
    """The reference's own check (``tests/test_archs.py``), on the port:
    with capacity relaxed so no route drops, prefill and decode logits
    equal the teacher-forced forward's within 5e-4."""
    cfg = dataclasses.replace(tcfg.get_smoke(arch), capacity_factor=8.0)
    p = T.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.as_tensor(np.random.default_rng(15).integers(
        0, cfg.vocab_size, (2, 24)))
    x, st, _ = T.forward(p, cfg, toks)
    assert float(st.dropped_frac) == 0.0
    full = T.unembed(p, cfg, x)
    log, cache, _ = T.prefill(p, cfg, toks[:, :16], cache_len=24)
    _close(log[:, 0], full[:, 15], dict(rtol=0, atol=5e-4))
    for t in range(16, 24):
        log, cache, _ = T.decode_step(p, cfg, cache, toks[:, t:t + 1], t)
        _close(log[:, 0], full[:, t], dict(rtol=0, atol=5e-4))


# ---------------------------------------------------------------------------
# xLSTM
# ---------------------------------------------------------------------------

def test_xlstm_blocks_and_steps_match_reference():
    """mlstm_block / mlstm_block_step / slstm_block / slstm_block_step:
    outputs and every state leaf within F32 (d 16, 2 heads, S 9)."""
    rng = np.random.default_rng(30)
    x = _randn(rng, 2, 9, 16)
    x1 = _randn(rng, 2, 1, 16)
    for decls, block, step, jblock, jstep in (
            (JX.mlstm_decls(16, 2), TX.mlstm_block, TX.mlstm_block_step,
             JX.mlstm_block, JX.mlstm_block_step),
            (JX.slstm_decls(16, 2), TX.slstm_block, TX.slstm_block_step,
             JX.slstm_block, JX.slstm_block_step)):
        jp, tp = _params(31, decls)
        out, st = block(tp, torch.as_tensor(x), 2)
        jout, jst = jblock(jp, jnp.asarray(x), 2)
        _close(out, jout, what=block.__name__)
        assert set(st) == set(jst)
        for k in st:
            assert st[k].dtype == torch.float32
            _close(st[k], jst[k], what=f"{block.__name__} {k}")
        out, st2 = step(tp, torch.as_tensor(x1), st, 2)
        jout, jst2 = jstep(jp, jnp.asarray(x1), jst, 2)
        _close(out, jout, what=step.__name__)
        for k in st2:
            _close(st2[k], jst2[k], what=f"{step.__name__} {k}")


def test_xlstm_prefill_state_equals_decode_steps_and_stays_finite():
    """The block's final state after S tokens equals S single steps from
    the zero state; the smoke model decodes 200 steps to finite logits."""
    rng = np.random.default_rng(32)
    x = torch.as_tensor(_randn(rng, 2, 12, 16))
    for decls, block, step, zero in (
            (JX.mlstm_decls(16, 2), TX.mlstm_block, TX.mlstm_block_step,
             {"C": (2, 2, 16, 16), "n": (2, 2, 16), "m": (2, 2)}),
            (JX.slstm_decls(16, 2), TX.slstm_block, TX.slstm_block_step,
             {k: (2, 2, 8) for k in "cnmh"})):
        _, tp = _params(33, decls)
        out, st = block(tp, x, 2)
        s = {k: torch.zeros(v) for k, v in zero.items()}
        outs = []
        for t in range(12):
            o, s = step(tp, x[:, t:t + 1], s, 2)
            outs.append(o)
        torch.testing.assert_close(torch.cat(outs, 1), out, rtol=1e-4,
                                   atol=1e-5)
        for k in st:
            torch.testing.assert_close(s[k], st[k], rtol=1e-4, atol=1e-5)
    cfg = tcfg.get_smoke("xlstm-1.3b")
    p = T.init_model(torch.Generator().manual_seed(1), cfg, "cpu")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 200)))
    cache = T.init_cache(cfg, 2, 201, "cpu")
    for t in range(200):
        log, cache, _ = T.decode_step(p, cfg, cache, toks[:, t:t + 1], t)
        assert bool(torch.isfinite(log).all()), t
    assert all(bool(torch.isfinite(v).all()) for _, v in tree_leaves(cache))


# ---------------------------------------------------------------------------
# int8 weight storage
# ---------------------------------------------------------------------------

def _equal(got, want, what=""):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(got, want), what


def test_quantize_params_and_dequant_match_reference_bitwise():
    """Leaf by leaf, float32 and bfloat16: codes and scales bitwise, with
    a column whose ratios fall on halves (round half to even); dequant
    bitwise in float32 and bfloat16; 1-D leaves stay as they are."""
    rng = np.random.default_rng(40)
    col = np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5], np.float32)
    tree = {"m": np.stack([col, _randn(rng, 6)], 1),
            "t": _randn(rng, 3, 4, 6),
            "v": _randn(rng, 6),
            "z": np.zeros((4, 3), np.float32)}
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        tq = TQ.quantize_params({k: torch.as_tensor(v).to(dt)
                                 for k, v in tree.items()})
        jq = JQ.quantize_params({k: jnp.asarray(v, jdt)
                                 for k, v in tree.items()})
        assert TQ.is_qleaf(tq["m"]) and not TQ.is_qleaf(tq["v"])
        for k in ("m", "t", "z"):
            _equal(tq[k][TQ.Q_KEY], torch.as_tensor(np.asarray(
                jq[k][JQ.Q_KEY])), k)
            _equal(tq[k][TQ.S_KEY], torch.as_tensor(np.asarray(
                jq[k][JQ.S_KEY])), k)
        assert tq["m"][TQ.Q_KEY][:, 0].tolist() == [127, 0, 2, 2, -2, 0]
        for odt, jodt in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
            dq, jdq = TQ.dequant_params(tq, odt), JQ.dequant_params(jq, jodt)
            for k in ("m", "t", "z"):
                _equal(dq[k], torch.as_tensor(np.asarray(
                    jdq[k].astype(jnp.float32))).to(odt), k)
            _equal(dq["v"], tq["v"])


def _decl_rows(tree):
    """(path, shape, dtype name, init) of every leaf of a declaration
    tree of either package."""
    rows = []

    def walk(t, path):
        if isinstance(t, (dict, list)):
            for k in (sorted(t) if isinstance(t, dict) else range(len(t))):
                walk(t[k], path + (k,))
            return
        dt = str(t.dtype).replace("torch.", "") if isinstance(
            t.dtype, torch.dtype) else np.dtype(t.dtype).name
        rows.append((path, tuple(t.shape), dt, t.init))
    walk(tree, ())
    return rows


def test_quantize_decls_matches_reference():
    """Leaf-level declarations: an MoE layer (with its 1-D norms) and the
    model-level storage, the port's per-layer shapes being the reference's
    stacked ones without the layer axis."""
    jc, cfg = jget_smoke("llama4-maverick-400b-a17b"), tcfg.get_smoke(
        "llama4-maverick-400b-a17b")
    for spec, jspec in zip(cfg.layers, jc.layers):
        assert _decl_rows(TQ.quantize_decls(T.layer_decls(cfg, spec))) == \
            _decl_rows(JQ.quantize_decls(JT.layer_decls(jc, jspec)))
    for arch in ("olmoe-1b-7b", "whisper-medium", "xlstm-1.3b"):
        jc, cfg = jget_smoke(arch), tcfg.get_smoke(arch)
        want = JQ.quantize_decls(JT.model_decls(jc))
        got = TQ.quantize_model_decls(T.model_decls(cfg))
        w_rows = {r[0]: r[1:] for r in _decl_rows(want)}
        n = 0
        for path, shape, dt, init in _decl_rows(got):
            if path[0] == "layers" or path[:2] == ("encoder", "layers"):
                continue
            assert w_rows[path] == (shape, dt, init), path
            n += 1
        assert n >= 3
        # every layer leaf is stored as codes, as the stacked reference's
        for path, shape, dt, _ in _decl_rows(got["layers"]):
            assert path[-1] in (TQ.Q_KEY, TQ.S_KEY), path


def _xlstm_two_cycles(get):
    c = get("xlstm-1.3b")
    return dataclasses.replace(c, n_layers=6, layers=c.layers * 2)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-maverick-400b-a17b",
                                  "whisper-medium", "xlstm-two-cycles"])
def test_quantize_model_matches_reference_bitwise(arch):
    """The port's model-level quantizer on its per-layer tree gives the
    codes and scales of the reference's ``quantize_params`` on the stacked
    tree, carried across by ``lm_params_from_numpy`` (scales shared over a
    scan group's layers and over whisper's encoder); ``dequant_params``
    bitwise; ``decode_step(dequant_params(...))`` within F32 of the
    reference's over a prefill and 4 steps."""
    if arch == "xlstm-two-cycles":
        jc, cfg = _xlstm_two_cycles(jget_smoke), _xlstm_two_cycles(
            tcfg.get_smoke)
        assert cfg.scan_groups()[0][1] == 2
    else:
        jc, cfg = jget_smoke(arch), tcfg.get_smoke(arch)
    jp = JT.init_model(jax.random.PRNGKey(0), jc)
    jq = JQ.quantize_params(jp)
    p = lm_params_from_numpy(_tree_np(jp), cfg, "cpu")
    tq = TQ.quantize_model(p, cfg)
    want = lm_params_from_numpy(_tree_np(jq), cfg, "cpu")
    got_leaves, want_leaves = list(tree_leaves(tq)), list(tree_leaves(want))
    assert [k for k, _ in got_leaves] == [k for k, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        _equal(g, w, str(path))
    assert sum(1 for path, _ in got_leaves if path[-1] == TQ.Q_KEY) > 10
    jdq = JQ.dequant_params(jq, jnp.float32)
    dq = TQ.dequant_params(tq, torch.float32)
    for (path, g), (_, w) in zip(tree_leaves(dq), tree_leaves(
            lm_params_from_numpy(_tree_np(jdq), cfg, "cpu"))):
        _equal(g, w, str(path))

    rng = np.random.default_rng(41)
    toks = rng.integers(0, cfg.vocab_size, (2, 16))
    kw = {}
    if cfg.frontend == "audio":
        kw["frames"] = _randn(rng, 2, cfg.encoder.n_frames,
                              cfg.encoder.d_input)
    jlog, jc_, _ = JT.prefill(jdq, jc, jnp.asarray(toks[:, :12]),
                              cache_len=16, **{k: jnp.asarray(v)
                                               for k, v in kw.items()})
    log, cache, _ = T.prefill(dq, cfg, torch.as_tensor(toks[:, :12]),
                              cache_len=16, **{k: torch.as_tensor(v)
                                               for k, v in kw.items()})
    _close(log, jlog)
    for t in range(12, 16):
        jlog, jc_, _ = JT.decode_step(jdq, jc, jc_, jnp.asarray(
            toks[:, t:t + 1]), jnp.int32(t))
        log, cache, _ = T.decode_step(dq, cfg, cache, torch.as_tensor(
            toks[:, t:t + 1]), t)
        _close(log, jlog, what=f"step {t}")


# ---------------------------------------------------------------------------
# Sinusoidal positions, the stub frontends, refusals
# ---------------------------------------------------------------------------

def test_sinusoidal_positions_and_frontends_match_reference():
    _close(TL.sinusoidal_positions(37, 16),
           JL.sinusoidal_positions(37, 16))
    # at whisper's positions: the two packages' pow may differ by an ulp,
    # which moves an angle of |pos| radians by about |pos| * 2^-23
    pos = np.array([0, 5, 1499, 447])
    got = _np(TL.sinusoidal_at(torch.as_tensor(pos), 1024))
    want = np.asarray(JL.sinusoidal_positions(1500, 1024))[pos]
    assert np.all(np.abs(got - want) <= 1e-5 + 2.0 ** -22 * pos[:, None])
    rng = np.random.default_rng(50)
    for arch in ("whisper-medium", "internvl2-26b", "granite-8b"):
        jc, cfg = jget_smoke(arch), tcfg.get_smoke(arch)
        assert TF.frontend_feature_shape(cfg, 3) == \
            JF.frontend_feature_shape(jc, 3)
        jdecl = JF.frontend_decls(jc)
        if jdecl is None:
            assert TF.frontend_decls(cfg) is None
            continue
        jp, tp = _params(51, jdecl)
        assert tuple(tp["proj"].shape) == TF.frontend_decls(
            cfg)["proj"].shape
        feats = _randn(rng, *TF.frontend_feature_shape(cfg, 2))
        _close(TF.apply_frontend(tp, cfg, torch.as_tensor(feats)),
               JF.apply_frontend(jp, jc, jnp.asarray(feats)))


def test_stub_inputs_and_short_vision_prompts_are_refused():
    """A prompt shorter than the patches (the reference would build a
    sequence of the wrong length), a vision config without patches and an
    encoder config without frames raise ``ValueError``; so does the
    engine, which passes no stub inputs, for either config."""
    cfg = tcfg.get_smoke("internvl2-26b")
    p = T.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    patches = torch.zeros((1, cfg.n_patches, cfg.d_model))
    toks = torch.zeros((1, cfg.n_patches - 1), dtype=torch.long)
    with pytest.raises(ValueError, match=f"at least {cfg.n_patches}"):
        T.forward(p, cfg, toks, patches=patches)
    with pytest.raises(ValueError, match=f"at least {cfg.n_patches}"):
        T.prefill(p, cfg, toks, patches=patches, cache_len=16)
    with pytest.raises(ValueError, match="patches="):
        T.prefill(p, cfg, torch.zeros((1, 9), dtype=torch.long))
    assert T.prefill(p, cfg, torch.zeros((1, cfg.n_patches),
                                         dtype=torch.long),
                     patches=patches)[2] == cfg.n_patches - 1
    w = tcfg.get_smoke("whisper-medium")
    with pytest.raises(ValueError, match="frames="):
        T.forward(T.init_model(torch.Generator(), w, "cpu"), w,
                  torch.zeros((1, 4), dtype=torch.long))
    for c in (cfg, w):
        with pytest.raises(ValueError, match=r"prefill\(frames=/patches=\)"):
            ServeEngine(c, {}, batch_slots=1, cache_len=8, device="cpu")
    eng = ServeEngine(tcfg.get_smoke("xlstm-1.3b"), T.init_model(
        torch.Generator(), tcfg.get_smoke("xlstm-1.3b"), "cpu"),
        batch_slots=1, cache_len=8, device="cpu")
    eng.run([Request(0, np.array([3, 4]), 3)])
    assert eng.stats["generated"] == 2     # after the prefill's token
