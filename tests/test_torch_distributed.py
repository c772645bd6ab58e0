"""The port's sharded LM paths and ``distributed/`` against the JAX
reference, on the CPU.

The reference's meshes are built with ``jax.make_mesh(shape, ("data",
"model"), axis_types=(AxisType.Auto,) * 2)``: its ``logical`` constrains
shardings, which JAX allows on Auto axes only (``make_host_mesh`` builds
Explicit ones under jax 0.9).  The port's meshes repeat the CPU
(``Mesh(shape, devices=["cpu"] * n)``).  The ``install`` fixture installs
both and clears both on teardown, so no mesh outlives its test.

* Rules: ``MeshRules.spec`` equal to the reference's over every rule name,
  the 16 ``default_rules`` flag combinations, four meshes and dimensions
  that do and do not divide (pure Python).
* Compression: codes, scales and residuals bitwise, ``compression_ratio``
  equal (both divide correctly rounded and round half to even).
* Sharded paths, 1 x 1 in-process and 2 x 2 through one subprocess
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4`` needs a fresh
  process; the reference's outputs come back as an ``.npz``): within
  ``F32`` (``rtol = atol = 1e-5``), the routes and ``dropped_frac``
  exactly.  The two packages run the same operations in the same order;
  their matmul, ``exp`` and softmax kernels round differently.
* Gradients of the shard-map ``lm_loss`` against ``jax.grad``: ``F32``.
* The folded causal schedule: within 2e-4 of the reference (the
  reference's own tolerance, ``tests/test_attention.py``) and bitwise
  equal to the port's plain schedule.

The ``gpu`` test (skipped without a card) imports no JAX and runs with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \\
        tests/test_torch_distributed.py
"""
import dataclasses
import importlib
import itertools
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.distributed import Mesh
from repro_torch.distributed import collectives as col
from repro_torch.distributed import compression as TC
from repro_torch.distributed import sharding as TS
from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from repro_torch.models.layers import tree_leaves, tree_unflatten
from repro_torch.weights import lm_cache_from_numpy, lm_params_from_numpy

torch.set_num_threads(1)
F32 = dict(rtol=1e-5, atol=1e-5)
AXES = ("data", "model")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_BUDGET_S = 45


class _Lazy:
    """A module of the reference, imported on first use: the card's
    machine has no JAX, and the gpu test never touches one."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


jax, jnp = _Lazy("jax"), _Lazy("jax.numpy")
JT, JA = _Lazy("repro.models.transformer"), _Lazy("repro.models.attention")
JM, JL = _Lazy("repro.models.moe"), _Lazy("repro.models.layers")
JS, JC = _Lazy("repro.distributed.sharding"), _Lazy(
    "repro.distributed.compression")
JCFG = _Lazy("repro.configs")


def _np(x):
    return np.asarray(x.detach().float().cpu().numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32))


def _close(got, want, tol=F32, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _cpu_mesh(shape):
    return Mesh(shape, AXES, ["cpu"] * math.prod(shape))


def _jmesh(shape):
    return jax.make_mesh(shape, AXES,
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.fixture
def install():
    """``install(shape, **rule_flags)`` installs a mesh of ``shape`` and
    ``default_rules(False, **rule_flags)`` in both packages and returns
    (reference mesh, port mesh); both are cleared on teardown."""
    def go(shape=(1, 1), **flags):
        jm, tm = _jmesh(shape), _cpu_mesh(shape)
        JS.set_mesh_rules(jm, JS.default_rules(False, **flags))
        TS.set_mesh_rules(tm, TS.default_rules(False, **flags))
        return jm, tm
    try:
        yield go
    finally:
        JS.clear_mesh_rules()
        TS.clear_mesh_rules()


def _smoke(arch, **over):
    jcfg = dataclasses.replace(JCFG.get_smoke(arch), **over)
    cfg = dataclasses.replace(tcfg.get_smoke(arch), **over)
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, lm_params_from_numpy(_tree_np(jp), cfg, "cpu")


# ---------------------------------------------------------------------------
# Mesh, rules and collectives
# ---------------------------------------------------------------------------

class _Stub:
    def __init__(self, shape):
        self.shape = shape


RULE_MESHES = {"1x1": {"data": 1, "model": 1}, "4x2": {"data": 4, "model": 2},
               "16x16": {"data": 16, "model": 16},
               "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _spec_or_error(rules, axes, shape, mesh):
    try:
        return tuple(rules.spec(axes, shape, mesh))
    except KeyError as e:        # a rule names an axis the mesh lacks
        return ("KeyError", str(e))


@pytest.mark.parametrize("mesh", list(RULE_MESHES))
def test_rules_match_the_reference(mesh):
    """Every rule name (and None, and a name no rule has) alone and in
    pairs, under all 16 flag combinations, on dimensions that divide the
    mesh axes and dimensions that do not."""
    stub = _Stub(RULE_MESHES[mesh])
    names = [k for k, _ in TS.default_rules(False).rules] + [None, "nope"]
    dims = (1, 2, 3, 8, 40, 64, 256, 4096, 14336)
    pairs = ((4096, 14336), (40, 64), (2, 512), (32, 3))
    for flags in itertools.product((False, True), repeat=4):
        tr, jr = TS.default_rules(*flags), JS.default_rules(*flags)
        assert tr.rules == jr.rules
        for n in names:
            assert tr.get(n) == jr.get(n)
            for d in dims:
                assert _spec_or_error(tr, (n,), (d,), stub) == \
                    _spec_or_error(jr, (n,), (d,), stub), (flags, n, d)
        for a, b in itertools.product(names, repeat=2):
            for shape in pairs:
                assert _spec_or_error(tr, (a, b), shape, stub) == \
                    _spec_or_error(jr, (a, b), shape, stub), (flags, a, b)
    assert P("data", None) == ("data", None) and P() == ()


def test_mesh_and_logical():
    m = _cpu_mesh((2, 3))
    assert m.shape == {"data": 2, "model": 3} and m.size == 6
    assert [m.coords(s) for s in (0, 1, 3, 5)] == [
        {"data": 0, "model": 0}, {"data": 0, "model": 1},
        {"data": 1, "model": 0}, {"data": 1, "model": 2}]
    assert col.axis_index(m, ("data", "model"), 4) == 4
    assert col.axis_index(m, ("model", "data"), 4) == 3
    assert col.groups(m, "data") == [[0, 3], [1, 4], [2, 5]]
    h = make_host_mesh("cpu")
    assert h.shape == {"data": 1, "model": 1} and h.devices == (
        torch.device("cpu"),)
    with pytest.raises(ValueError, match="needs 4 devices"):
        Mesh((2, 2), AXES, ["cpu"] * 3)
    with pytest.raises(ValueError, match="distinct"):
        Mesh((2, 2), ("data", "data"), ["cpu"] * 4)
    x = torch.zeros((4, 6))
    assert TS.logical(x, "batch", "p_mlp") is x       # no mesh installed
    TS.set_mesh_rules(m, TS.default_rules(True))
    try:
        assert TS.current_mesh() is m
        assert TS.logical(x, None, "p_mlp") is x
        with pytest.raises(KeyError):                  # "pod" is absent
            TS.logical(x, "batch", None)
    finally:
        TS.clear_mesh_rules()
    assert TS.current_mesh() is None


def test_collectives_semantics_and_autograd():
    """Split / join round trips (tuple axes, replicated axes), the psum
    order, all_to_all's chunk routing, and gradients through a split, an
    all-to-all, a psum and a join (``gradcheck`` in float64)."""
    m = _cpu_mesh((2, 2))
    x = torch.arange(48.).reshape(4, 12)
    for spec in (P("data", "model"), P(("data", "model"), None),
                 P(None, ("model", "data")), P("model"), P()):
        assert torch.equal(col.join(col.split(x, spec, m), spec, m), x)
    parts = col.split(x, P(None, "model"), m)
    assert torch.equal(parts[0], parts[2])            # replicated on data
    s = col.psum([torch.tensor([float(i)]) for i in range(4)], AXES, m)
    assert all(torch.equal(t, torch.tensor([6.0])) for t in s)
    a = col.all_to_all([torch.arange(4) + 10 * i for i in range(4)],
                       "model", 0, 0, m)
    assert [t.tolist() for t in a] == [[0, 1, 10, 11], [2, 3, 12, 13],
                                       [20, 21, 30, 31], [22, 23, 32, 33]]
    w = torch.randn(4, 12, dtype=torch.float64, requires_grad=True)

    def f(w):
        parts = col.split(w, P("data", "model"), m)
        parts = col.all_to_all(parts, "model", 1, 0, m)
        return col.join(col.psum(parts, "data", m), P(None, "model"), m)
    assert f(w).shape == (4, 6)
    assert torch.autograd.gradcheck(f, (w,))


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

def _grad_trees(rng):
    j = {"a": rng.normal(size=(64,)).astype(np.float32) * 1e-3,
         "b": {"c": rng.normal(size=(8, 16)).astype(np.float32),
               "d": np.zeros((5,), np.float32)}}
    t = TL.tree_map(torch.as_tensor, {"a": j["a"], "b": dict(j["b"])})
    return j, t


def test_compression_matches_the_reference_bitwise():
    """Three error-feedback steps over one tree: codes, scales, residuals
    and the dequantised tree bitwise; compression_ratio equal; the plain
    quantiser at a Python-number scale bitwise."""
    rng = np.random.default_rng(0)
    jg, tg = _grad_trees(rng)
    jef, tef = JC.ef_init(jg), TC.ef_init(tg)
    for step in range(3):
        jq, js, jef = JC.ef_compress(jg, jef)
        tq, ts, tef = TC.ef_compress(tg, tef)
        for (path, got), want in zip(
                tree_leaves({"q": tq, "s": ts, "r": tef.residual,
                             "d": TC.ef_decompress(tq, ts)}),
                [w for _, w in tree_leaves(_tree_np(
                    {"q": jq, "s": js, "r": jef.residual,
                     "d": JC.ef_decompress(jq, js)}))]):
            assert np.array_equal(got.numpy(), np.asarray(want)), (step,
                                                                   path)
            assert got.dtype == {"q": torch.int8}.get(path[0],
                                                      torch.float32)
    assert TC.compression_ratio(tg) == JC.compression_ratio(jg)
    x = rng.normal(size=(300,)).astype(np.float32)
    scale = float(np.abs(x).max()) / 127.0
    q = TC.quantize_int8(torch.as_tensor(x), scale)
    assert np.array_equal(q.numpy(), np.asarray(JC.quantize_int8(x, scale)))
    assert np.array_equal(TC.dequantize_int8(q, scale).numpy(), np.asarray(
        JC.dequantize_int8(np.asarray(q), scale)))
    with pytest.raises(ValueError, match="does not match"):
        TC.ef_compress(tg, TC.ef_init({"a": tg["a"]}))


def test_int8_quant_roundtrip_error_bound():
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(256,)).astype(
        np.float32))
    scale = float(x.abs().max()) / 127.0
    back = TC.dequantize_int8(TC.quantize_int8(x, scale), scale)
    assert float((back - x).abs().max()) <= scale * 0.5 + 1e-7


def test_error_feedback_unbiased_over_steps():
    """With error feedback the accumulated compressed sum tracks the true
    sum (the reference's test, on the port)."""
    g = torch.as_tensor(np.random.default_rng(1).normal(size=(64,)).astype(
        np.float32) * 1e-3)
    ef, total = TC.ef_init({"w": g}), torch.zeros_like(g)
    for _ in range(50):
        q8, scales, ef = TC.ef_compress({"w": g}, ef)
        total = total + TC.ef_decompress(q8, scales)["w"]
    assert float((total - g * 50).norm() / (g * 50).norm()) < 0.02


def test_sgd_with_compressed_grads_still_converges():
    w = torch.tensor([3.0, -2.0, 1.5, 4.0])
    target = torch.ones(4)
    ef = TC.ef_init({"w": w})
    for _ in range(300):
        q8, s, ef = TC.ef_compress({"w": 2 * (w - target)}, ef)
        w = w - 0.05 * TC.ef_decompress(q8, s)["w"]
    _close(w, target, dict(rtol=0, atol=1e-2))


# ---------------------------------------------------------------------------
# Sharded paths at 1 x 1, in-process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,over", [
    ("olmoe-1b-7b", {}), ("llama4-maverick-400b-a17b", {"seq_shard": True})],
    ids=["olmoe", "llama4-seq-shard"])
def test_moe_shardmap_forward_matches_the_reference(install, arch, over):
    """``forward`` through ``moe_apply_shardmap`` (the dispatch in
    ``transformer._moe``): hidden states and aux_loss within F32,
    dropped_frac exactly; the port's equals its gather path there."""
    jcfg, cfg, jp, tp = _smoke(arch, moe_impl="shardmap", **over)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    install((1, 1))
    jh, jst, _ = jax.jit(lambda p, t: JT.forward(p, jcfg, t))(jp, toks)
    th, tst, _ = T.forward(tp, cfg, torch.as_tensor(toks))
    _close(th, jh)
    _close(tst.aux_loss, jst.aux_loss)
    assert float(tst.dropped_frac) == float(jst.dropped_frac)
    TS.clear_mesh_rules()
    gh, gst, _ = T.forward(tp, cfg, torch.as_tensor(toks))
    _close(th, gh)
    assert float(gst.dropped_frac) == float(tst.dropped_frac)


class _Dispatches:
    """Records the kept (expert, token) routes of every ``moe.dispatch``
    call while open."""

    def __enter__(self):
        self.calls, self._own = [], TM.dispatch

        def rec(sel, capacity):
            out = self._own(sel, capacity)
            _, idx, valid = out
            self.calls.append(frozenset(
                (e, int(idx[e, c])) for e, c in valid.nonzero().tolist()))
            return out
        TM.dispatch = rec
        return self.calls

    def __exit__(self, *exc):
        TM.dispatch = self._own


def _ref_kept(jp, x, top_k, capacity):
    """The reference's kept routes: its router math and its two
    ``jax.lax.top_k`` choices (``repro/models/moe.py:182-190``)."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf, jp["router"]), -1)
    top_p, top_i = jax.lax.top_k(probs, top_k)
    top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    sel = jnp.zeros(probs.shape, jnp.float32).at[
        jnp.arange(xf.shape[0])[:, None], top_i].set(top_p)
    gate, idx = jax.lax.top_k(jnp.where(sel.T > 0, sel.T, -1.0), capacity)
    idx = np.asarray(idx)
    return frozenset((int(e), int(idx[e, c]))
                     for e, c in zip(*np.nonzero(np.asarray(gate) > 0)))


def _moe_inputs(seed, top_k, shared, E=4, d=32, f=48):
    jp = JL.init_tree(jax.random.PRNGKey(seed),
                      JM.moe_decls(d, E, f, shared, 40))
    tp = TL.tree_map(lambda a: torch.as_tensor(np.array(a)), _tree_np(jp))
    x = np.random.default_rng(seed).normal(size=(4, 8, d)).astype(
        np.float32)
    return jp, tp, x, dict(n_experts=E, top_k=top_k, act="silu",
                           shared=shared)


@pytest.mark.parametrize("top_k,shared,factor", [
    (2, False, 0.5), (1, True, 0.25), (2, True, 8.0)])
def test_moe_shardmap_routes_match_the_reference(install, top_k, shared,
                                                 factor):
    """``moe_apply_shardmap`` at 1 x 1 on 32 tokens: the output within
    F32, the kept routes and dropped_frac exactly."""
    jp, tp, x, kw = _moe_inputs(top_k, top_k, shared)
    jm, tm = install((1, 1))
    jo, jst = jax.jit(lambda p, x: JM.moe_apply_shardmap(
        p, x, mesh=jm, capacity_factor=factor, **kw))(jp, x)
    with _Dispatches() as calls:
        to, tst = TM.moe_apply_shardmap(tp, torch.as_tensor(x), mesh=tm,
                                        capacity_factor=factor, **kw)
    _close(to, jo)
    _close(tst.aux_loss, jst.aux_loss)
    assert float(tst.dropped_frac) == float(jst.dropped_frac)
    cap = TM._capacity(32, 4, top_k, factor)
    assert calls == [_ref_kept(jp, x, top_k, cap)]


def test_moe_shardmap_falls_back_where_the_reference_does():
    """Experts, batch or (under seq_shard) sequence that do not divide:
    ``moe_apply`` exactly; one decode token under seq_shard is such a
    case."""
    _, tp, x, kw = _moe_inputs(0, 2, False)
    x = torch.as_tensor(x)
    want = TM.moe_apply(tp, x, capacity_factor=1.0, **kw)
    for shape, xb, seq in (((1, 3), x, False), ((3, 1), x, False),
                           ((1, 2), x[:, :1], True)):
        got = TM.moe_apply_shardmap(tp, xb, mesh=_cpu_mesh(shape),
                                    capacity_factor=1.0, seq_shard=seq, **kw)
        ref = want if xb is x else TM.moe_apply(tp, xb, capacity_factor=1.0,
                                                **kw)
        assert torch.equal(got[0], ref[0]) and torch.equal(
            got[1].dropped_frac, ref[1].dropped_frac)


def _sd_decode(cfg, params, toks, steps, dev="cpu"):
    cache = T.init_cache(cfg, toks.shape[0], 16, dev)
    rows = []
    for t in range(steps):
        lg, cache, _ = T.decode_step(params, cfg, cache,
                                     torch.as_tensor(toks[:, t:t + 1]).to(
                                         dev), t)
        rows.append(lg)
    return torch.cat(rows, 1), cache


def test_sd_sharded_decode_matches_the_reference(install):
    """8 decode steps of recurrentgemma smoke at ``sd_decode_frac=1.0``
    through ``_sd_matvec_sharded``: logits and every cache leaf (the
    sigma-delta references included) within F32."""
    jcfg, cfg, jp, tp = _smoke("recurrentgemma-2b", sd_decode_frac=1.0)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 8))
    install((1, 1))
    step = jax.jit(lambda p, c, t, i: JT.decode_step(p, jcfg, c, t, i))
    jc, jl = JT.init_cache(jcfg, 1, 16), []
    for t in range(8):
        lg, jc, _ = step(jp, jc, toks[:, t:t + 1], jnp.int32(t))
        jl.append(np.asarray(lg))
    tl, tc = _sd_decode(cfg, tp, toks, 8)
    _close(tl, np.concatenate(jl, 1))
    want = lm_cache_from_numpy(_tree_np(jc), cfg, 16, "cpu")
    for (path, got), (_, w) in zip(tree_leaves(tc), tree_leaves(want)):
        _close(got, w, what=str(path))


@pytest.mark.parametrize("B,pos,window,seq_axes,batch_axis", [
    (2, 19, 0, AXES, None), (3, 31, 8, ("model",), "data")])
def test_flash_decode_shardmap_matches_the_reference(install, B, pos, window,
                                                     seq_axes, batch_axis):
    """Against the reference's and against ``decode_attention``."""
    rng = np.random.default_rng(B)
    q = rng.normal(size=(B, 1, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(B, 32, 2, 8)).astype(np.float32)
            for _ in range(2))
    jm, tm = install((1, 1))
    want = JA.flash_decode_shardmap(q, k, v, jnp.int32(pos), jm, seq_axes,
                                    batch_axis, window)
    got = TA.flash_decode_shardmap(*map(torch.as_tensor, (q, k, v)), pos,
                                   tm, seq_axes, batch_axis, window)
    _close(got, want)
    _close(got, TA.decode_attention(*map(torch.as_tensor, (q, k, v)), pos,
                                    window))


def test_int8_psum_matches_the_reference(install):
    g = np.random.default_rng(3).normal(size=(4, 64)).astype(np.float32)
    jm, tm = install((1, 1))
    JP = jax.sharding.PartitionSpec
    want = JS.shard_map(lambda t: JC.int8_psum(t, "data"), mesh=jm,
                        in_specs=JP("data", None), out_specs=JP(),
                        check_vma=False)(g)
    got = col.join(TC.int8_psum(col.split(torch.as_tensor(g),
                                          P("data", None), tm), "data", tm),
                   P(), tm)
    _close(got, want)


def test_shardmap_lm_loss_gradients_match_jax_grad(install):
    """``lm_loss`` of olmoe smoke with ``moe_impl="shardmap"``: the loss
    and every gradient leaf within F32 of ``jax.grad`` of the reference's
    (autograd through the shard lists)."""
    jcfg, cfg, jp, tp = _smoke("olmoe-1b-7b", moe_impl="shardmap")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 32))
    labels = rng.integers(0, cfg.vocab_size, (2, 32))
    install((1, 1))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: JT.lm_loss(
        p, jcfg, toks, labels, loss_chunk=16)[0]))(jp)
    leaves = [w.requires_grad_() for _, w in tree_leaves(tp)]
    tl, _ = T.lm_loss(tp, cfg, torch.as_tensor(toks),
                      torch.as_tensor(labels), loss_chunk=16)
    tg = tree_unflatten(tp, torch.autograd.grad(tl, leaves))
    _close(tl, jl)
    want = lm_params_from_numpy(_tree_np(jg), cfg, "cpu")
    for (path, g), (_, w) in zip(tree_leaves(tg), tree_leaves(want)):
        _close(g, w, what=str(path))


@pytest.mark.parametrize("chunk,S", [(8, 64), (16, 64), (16, 50)])
def test_folded_causal_schedule(chunk, S):
    """``fold=True`` within 2e-4 of the reference's fold and bitwise equal
    to the port's plain schedule (a fully masked block changes nothing);
    S = 50 pads to 64 and keeps the fold (Nq = 4)."""
    rng = np.random.default_rng(chunk + S)
    q = rng.normal(size=(2, S, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, S, 2, 8)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=True, chunk_q=chunk, chunk_kv=chunk)
    want = JA.flash_attention(q, k, v, fold=True, **kw)
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    got = TA.flash_attention(tq, tk, tv, fold=True, **kw)
    _close(got, want, dict(rtol=2e-4, atol=2e-4))
    assert torch.equal(got, TA.flash_attention(tq, tk, tv, **kw))


# ---------------------------------------------------------------------------
# 2 x 2: the reference in a subprocess, the port in-process
# ---------------------------------------------------------------------------

_CHILD = r'''
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_disable_most_optimizations", True)    # compile fast
from jax.sharding import AxisType, PartitionSpec as P
from repro.configs import get_smoke
from repro.distributed import sharding as JS
from repro.distributed.compression import int8_psum
from repro.models import attention as JA
from repro.models import transformer as JT
assert jax.device_count() == 4, jax.devices()
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}


def sm(f, i, o):
    return JS.shard_map(f, mesh=mesh, in_specs=i, out_specs=o,
                        check_vma=False)


def raw(t, g):
    return (jax.lax.all_to_all(t, "model", 1, 0, tiled=True),
            jax.lax.all_gather(t, "data", axis=0, tiled=True),
            jax.lax.psum(t, ("data", "model")), int8_psum(g, "data"))


x = np.arange(32, dtype=np.float32).reshape(4, 8)
rng = np.random.default_rng(5)
g = rng.normal(size=(4, 64)).astype(np.float32)
(out["a2a"], out["gather"], out["psum"], out["int8_psum"]) = jax.jit(sm(
    raw, (P("data", "model"), P("data", None)),
    (P("data", "model"), P(None, "model"), P(), P())))(x, g)
q = rng.normal(size=(2, 1, 4, 8)).astype(np.float32)
kc = rng.normal(size=(2, 32, 2, 8)).astype(np.float32)
vc = rng.normal(size=(2, 32, 2, 8)).astype(np.float32)
out["fd_seq"] = JA.flash_decode_shardmap(q, kc, vc, jnp.int32(19), mesh,
                                         ("data", "model"), None)
JS.set_mesh_rules(mesh, JS.default_rules(False))
for name, arch, over, (B, S) in MOE_CASES:
    cfg = dataclasses.replace(get_smoke(arch), moe_impl="shardmap", **over)
    p = JT.init_model(jax.random.PRNGKey(0), cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, S))
    h, st, _ = jax.jit(lambda p, t: JT.forward(p, cfg, t))(p, toks)
    out[name + "_h"], out[name + "_aux"] = h, st.aux_loss
    out[name + "_drop"] = st.dropped_frac
cfg = dataclasses.replace(get_smoke("recurrentgemma-2b"),
                          sd_decode_frac=SD_FRAC)
p = JT.init_model(jax.random.PRNGKey(0), cfg)
toks = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 4))
cache = JT.init_cache(cfg, 2, 16)
step = jax.jit(lambda p, c, t, i: JT.decode_step(p, cfg, c, t, i))
lg = []
for t in range(4):
    l, cache, _ = step(p, cache, toks[:, t:t + 1], jnp.int32(t))
    lg.append(l)
out["sd_logits"] = jnp.concatenate(lg, 1)
for i, leaf in enumerate(jax.tree.leaves(cache)):
    out[f"sd_cache_{i}"] = leaf
JS.clear_mesh_rules()
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
'''
MOE_CASES = (("olmoe", "olmoe-1b-7b", {}, (4, 32)),
             ("llama4", "llama4-maverick-400b-a17b", {"seq_shard": True},
              (2, 32)))
SD_FRAC = 0.5      # per-shard selection: cap_local < the shard's rows


@pytest.fixture(scope="module")
def ref_2x2(tmp_path_factory):
    """The reference's 2 x 2 outputs, from one fresh process with four
    host devices."""
    path = tmp_path_factory.mktemp("ref2x2") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    code = (f"MOE_CASES = {MOE_CASES!r}\nSD_FRAC = {SD_FRAC!r}\n" + _CHILD)
    subprocess.run([sys.executable, "-c", code, str(path)], env=env,
                   check=True, timeout=3 * CHILD_BUDGET_S)
    return dict(np.load(path))


def test_collectives_match_the_reference_2x2(ref_2x2):
    m = _cpu_mesh((2, 2))
    x = col.split(torch.arange(32.).reshape(4, 8), P("data", "model"), m)
    assert np.array_equal(col.join(col.all_to_all(x, "model", 1, 0, m),
                                   P("data", "model"), m), ref_2x2["a2a"])
    assert np.array_equal(col.join(col.all_gather(x, "data", 0, m),
                                   P(None, "model"), m), ref_2x2["gather"])
    assert np.array_equal(col.join(col.psum(x, AXES, m), P(), m),
                          ref_2x2["psum"])
    rng = np.random.default_rng(5)
    g = torch.as_tensor(rng.normal(size=(4, 64)).astype(np.float32))
    got = col.join(TC.int8_psum(col.split(g, P("data", None), m), "data", m),
                   P(), m)
    _close(got, ref_2x2["int8_psum"])
    # within n_shards * scale / 2 of the float32 psum
    scale = float(g.abs().max()) / 127.0
    assert float((got - (g[:2] + g[2:])).abs().max()) <= 2 * scale / 2
    q, k, v = (torch.as_tensor(rng.normal(size=s).astype(np.float32))
               for s in ((2, 1, 4, 8), (2, 32, 2, 8), (2, 32, 2, 8)))
    _close(TA.flash_decode_shardmap(q, k, v, 19, m, AXES, None),
           ref_2x2["fd_seq"])
    # the batch over "data", the sequence over "model": the port's own
    # decode_attention
    _close(TA.flash_decode_shardmap(q, k, v, 19, m, ("model",), "data"),
           TA.decode_attention(q, k, v, 19))


@pytest.mark.parametrize("case", [c[0] for c in MOE_CASES])
def test_moe_shardmap_matches_the_reference_2x2(ref_2x2, case):
    name, arch, over, (B, S) = next(c for c in MOE_CASES if c[0] == case)
    cfg = dataclasses.replace(tcfg.get_smoke(arch), moe_impl="shardmap",
                              **over)
    jcfg = dataclasses.replace(JCFG.get_smoke(arch), moe_impl="shardmap",
                               **over)
    tp = lm_params_from_numpy(_tree_np(JT.init_model(
        jax.random.PRNGKey(0), jcfg)), cfg, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(B, S))
    TS.set_mesh_rules(_cpu_mesh((2, 2)), TS.default_rules(False))
    try:
        h, st, _ = T.forward(tp, cfg, torch.as_tensor(toks))
    finally:
        TS.clear_mesh_rules()
    _close(h, ref_2x2[name + "_h"])
    _close(st.aux_loss, ref_2x2[name + "_aux"])
    assert float(st.dropped_frac) == float(ref_2x2[name + "_drop"])


def test_sd_sharded_decode_matches_the_reference_2x2(ref_2x2):
    cfg = dataclasses.replace(tcfg.get_smoke("recurrentgemma-2b"),
                              sd_decode_frac=SD_FRAC)
    jcfg = dataclasses.replace(JCFG.get_smoke("recurrentgemma-2b"),
                               sd_decode_frac=SD_FRAC)
    tp = lm_params_from_numpy(_tree_np(JT.init_model(
        jax.random.PRNGKey(0), jcfg)), cfg, "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 4))
    TS.set_mesh_rules(_cpu_mesh((2, 2)), TS.default_rules(False))
    try:
        lg, cache = _sd_decode(cfg, tp, toks, 4)
    finally:
        TS.clear_mesh_rules()
    _close(lg, ref_2x2["sd_logits"])
    jc = JT.init_cache(jcfg, 2, 16)
    n = len(jax.tree.leaves(jc))
    tree = jax.tree.unflatten(jax.tree.structure(jc),
                              [ref_2x2[f"sd_cache_{i}"] for i in range(n)])
    want = lm_cache_from_numpy(tree, cfg, 16, "cpu")
    for (path, got), (_, w) in zip(tree_leaves(cache), tree_leaves(want)):
        _close(got, w, what=str(path))


# ---------------------------------------------------------------------------
# The port's own identities at 2 x 2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq_shard", [False, True])
def test_moe_shardmap_is_moe_apply_per_shard(seq_shard):
    """At 2 x 2 each token shard's output is ``moe_apply`` on its tokens
    (within F32: the expert GEMMs see other row counts), its kept routes
    are that call's exactly, and dropped_frac is the mean of the shards'
    fractions."""
    _, tp, x, kw = _moe_inputs(7, 2, True)
    x = torch.as_tensor(x)
    m = _cpu_mesh((2, 2))
    spec = P("data", "model" if seq_shard else None, None)
    with _Dispatches() as calls:
        out, st = TM.moe_apply_shardmap(tp, x, mesh=m, capacity_factor=0.5,
                                        seq_shard=seq_shard, **kw)
    parts = col.split(x, spec, m)
    shards = range(4) if seq_shard else (0, 2)
    with _Dispatches() as want_calls:
        want = [TM.moe_apply(tp, parts[s], capacity_factor=0.5, **kw)
                for s in shards]
    for s, (o, _) in zip(shards, want):
        _close(col.split(out, spec, m)[s], o)
    assert [calls[s] for s in shards] == want_calls
    assert math.isclose(float(st.dropped_frac), float(np.mean(
        [float(w[1].dropped_frac) for w in want])), rel_tol=1e-6)


def test_sharded_sd_at_full_capacity_is_unsharded():
    cfg = dataclasses.replace(tcfg.get_smoke("recurrentgemma-2b"),
                              sd_decode_frac=1.0)
    tp = T.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 6))
    plain, pc = _sd_decode(cfg, tp, toks, 6)
    TS.set_mesh_rules(_cpu_mesh((2, 2)), TS.default_rules(False))
    try:
        sharded, sc = _sd_decode(cfg, tp, toks, 6)
    finally:
        TS.clear_mesh_rules()
    _close(sharded, plain)
    for (path, a), (_, b) in zip(tree_leaves(sc), tree_leaves(pc)):
        _close(a, b, what=str(path))


# ---------------------------------------------------------------------------
# On the card (gpu marker; skipped without one)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_sharded_paths_on_the_card_match_the_cpu():
    """Shards on repeated ``cuda:0`` against the same shards on the CPU
    (float32, TF32 off): the shard-map forward of olmoe smoke and 4
    sharded sigma-delta decode steps within 1e-4, dropped_frac equal;
    flash decode within 1e-5; the fold bitwise equal to the plain
    schedule on the card; int8_psum card == CPU bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {}
        for dev in ("cpu", "cuda"):
            m = Mesh((2, 2), AXES, [dev] * 4)
            out = {}
            for arch, over in (("olmoe-1b-7b", {"moe_impl": "shardmap"}),
                               ("recurrentgemma-2b",
                                {"sd_decode_frac": 0.5})):
                cfg = dataclasses.replace(tcfg.get_smoke(arch), **over)
                p = TL.tree_map(lambda w: w.to(dev), T.init_model(
                    torch.Generator().manual_seed(0), cfg, "cpu"))
                toks = np.random.default_rng(1).integers(
                    0, cfg.vocab_size, (4, 16))
                TS.set_mesh_rules(m, TS.default_rules(False))
                try:
                    if cfg.n_experts:
                        h, st, _ = T.forward(p, cfg, torch.as_tensor(
                            toks).to(dev))
                        out[arch] = (h.cpu(), float(st.dropped_frac))
                    else:
                        out[arch] = (_sd_decode(cfg, p, toks, 4, dev)[0]
                                     .cpu(), None)
                finally:
                    TS.clear_mesh_rules()
            g = torch.Generator().manual_seed(3)
            q = torch.randn(4, 1, 4, 8, generator=g).to(dev)
            kv = torch.randn(2, 4, 64, 2, 8, generator=g).to(dev)
            out["fd"] = TA.flash_decode_shardmap(q, kv[0], kv[1], 40, m,
                                                 ("model",), "data").cpu()
            x = torch.randn(4, 128, 4, 16, generator=g).to(dev)
            kw = dict(causal=True, chunk_q=32, chunk_kv=32)
            fold = TA.flash_attention(x, x[:, :, :2], x[:, :, 2:], fold=True,
                                      **kw)
            assert torch.equal(fold, TA.flash_attention(
                x, x[:, :, :2], x[:, :, 2:], **kw))
            gr = torch.randn(4, 256, generator=g).to(dev)
            out["int8"] = col.join(TC.int8_psum(col.split(
                gr, P(("data", "model"), None), m), AXES, m), P(), m).cpu()
            runs[dev] = out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    cpu, card = runs["cpu"], runs["cuda"]
    for arch in ("olmoe-1b-7b", "recurrentgemma-2b"):
        _close(card[arch][0], cpu[arch][0], dict(rtol=0, atol=1e-4))
        assert card[arch][1] == cpu[arch][1]
    _close(card["fd"], cpu["fd"])
    assert torch.equal(card["int8"], cpu["int8"])
