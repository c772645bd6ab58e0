"""The port's dry-run (``launch/dryrun.py``, ``launch/specs.py``,
``launch/hlo_analysis.py``, ``models/scan_util.py``) and its kin against
the JAX reference, on the CPU, from declarations and small shapes only.

* Declarations: every leaf of ``model_decls``, ``cache_decls`` and the
  int8 storage (``quantize_model_decls``, built on ``quantize_decls``)
  has the reference's shape, dtype and logical axes, layer by layer (the reference's scan groups unstacked, their leading
  ``"p_layers"`` dropped; a quantised group's shared scale is every
  layer's scale), for all ten archs at full width.
* ``SHAPES``, ``cell_supported`` and ``all_cells`` equal the reference's.
* ``state_bytes_per_device`` for every supported (arch x shape) cell on
  both production mesh shapes equals the bytes per device the reference's
  ``default_rules(...).spec`` gives its own declarations (a stub mesh:
  only ``mesh.shape`` is read), exactly.
* FLOPs at small (B, S) for every smoke config and step kind:
  ``run_cell``'s ``flops_global`` equals ``FlopCounterMode`` around the
  same step on the CPU with real weights (under the same analysis switch,
  plus ``_recurrence_flops``), and the ``dot_general`` FLOPs of a walk of
  the reference's ``jax.make_jaxpr`` of its own step (``2 x output
  elements x contracted size``; scan bodies times their length, except
  the xLSTM sequence scan, which the reference's analysis counts once;
  into ``pjit``, ``checkpoint`` and ``custom_vjp`` bodies).  A
  ``dot_general`` with no contracted dimension is an outer product, which
  torch runs as an elementwise multiply that no FLOP counter counts, so
  the walk leaves it out.  Prefill and decode agree exactly, and so does
  training except xLSTM's: JAX's transpose of the mLSTM cell's outer
  product ``k v^T`` contracts over a head dimension and counts, where
  torch's backward of the multiply is a multiply and a sum; under the
  switch one step of it is left, within ``XLSTM_TRAIN_RTOL``.
* ``_recurrence_flops`` equals the reference's.
* Collectives: the rows the shard-map MoE issues on a (2, 2) mesh of
  ``meta`` devices equal those on ``["cpu"] * 4`` with real data; the
  modelled rows of granite smoke on (2, 2) equal bytes worked out here.
* ``launch.serve --production-lower`` writes a record (``launch.train``'s
  is held in ``tests/test_torch_lm_train.py``).
* Outside the analysis switch the xLSTM blocks are bitwise the plain
  per-timestep loop.
"""
import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as tcfg
from repro_torch.configs import ShapeSpec
from repro_torch.distributed import Mesh
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import (clear_mesh_rules,
                                              default_rules, set_mesh_rules)
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch import specs as SP
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as TX
from repro_torch.models.layers import tree_leaves
from repro_torch.models.quant_lm import quantize_model_decls
from repro_torch.models.scan_util import analysis

torch.set_num_threads(1)
AXES = ("data", "model")
SMALL_B, SMALL_S = 2, 16
XLSTM_TRAIN_RTOL = 5e-3
KIND_SHAPE = {"train": "train_4k", "prefill": "prefill_32k",
              "decode": "decode_32k"}


class _Lazy:
    """A module of the reference, imported on first use."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


jax, jnp = _Lazy("jax"), _Lazy("jax.numpy")
JCFG, JT = _Lazy("repro.configs"), _Lazy("repro.models.transformer")
JS, JQ = _Lazy("repro.distributed.sharding"), _Lazy("repro.models.quant_lm")
JD, JSU = _Lazy("repro.launch.dryrun"), _Lazy("repro.models.scan_util")
JL, JO = _Lazy("repro.train.loop"), _Lazy("repro.optim.schedules")


class StubMesh:
    def __init__(self, shape):
        self.shape = dict(zip(("pod",) + AXES if len(shape) == 3 else AXES,
                              shape))


MESHES = ((16, 16), (2, 16, 16))


# ---------------------------------------------------------------------------
# (a) declarations
# ---------------------------------------------------------------------------

def _name(dt) -> str:
    return str(dt).split(".")[-1] if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def _is_decl(x):
    return hasattr(x, "axes") and hasattr(x, "shape")


def _unstack_decl(tree):
    """One layer of a stacked reference decl tree: the leading dimension
    and its ``"p_layers"`` axis dropped; a quantised leaf's shared scale
    kept."""
    if isinstance(tree, dict) and set(tree) == {"__q", "__s"}:
        return {"__q": _unstack_decl(tree["__q"]),
                "__s": _leaf(tree["__s"])}
    if isinstance(tree, dict):
        return {k: _unstack_decl(v) for k, v in tree.items()}
    assert tree.axes[0] == "p_layers", tree
    return (tuple(tree.shape[1:]), tuple(tree.axes[1:]), _name(tree.dtype))


def _leaf(d):
    return (tuple(d.shape), tuple(d.axes), _name(d.dtype))


def _ref_layers(groups, cfg):
    out = []
    for i, (specs, count) in enumerate(cfg.scan_groups()):
        for _ in range(count):
            for j in range(len(specs)):
                out.append(_unstack_decl(groups[f"g{i}"][f"l{j}"]))
    return out


def _ref_flat(tree, cfg):
    """The reference's model decl tree as the port lays it out: groups
    unstacked into ``layers`` (and ``encoder/layers``)."""
    flat = {k: (_leaf(v) if _is_decl(v) else _map_leaf(v))
            for k, v in tree.items() if k not in ("groups", "encoder")}
    flat["layers"] = _ref_layers(tree["groups"], cfg)
    if "encoder" in tree:
        g = _unstack_decl(tree["encoder"]["groups"]["g0"]["l0"])
        flat["encoder"] = {"final_norm": _leaf(tree["encoder"]["final_norm"]),
                           "layers": [g] * cfg.encoder.n_layers}
    return flat


def _map_leaf(tree):
    if isinstance(tree, dict):
        return {k: _map_leaf(v) for k, v in tree.items()}
    return _leaf(tree)


def _port_flat(tree):
    if isinstance(tree, dict):
        return {k: _port_flat(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_port_flat(v) for v in tree]
    return _leaf(tree)


def _quantized_ref_flat(tree, cfg):
    """``quantize_decls`` of the reference's (stacked) tree, laid out as
    the port's; the embedding and head are quantised unstacked."""
    q = JQ.quantize_decls(tree)
    flat = {}
    for k, v in q.items():
        if k == "groups":
            flat["layers"] = _ref_layers(v, cfg)
        elif k == "encoder":
            g = _unstack_decl(v["groups"]["g0"]["l0"])
            flat["encoder"] = {"final_norm": _map_leaf(v["final_norm"]),
                               "layers": [g] * cfg.encoder.n_layers}
        else:
            flat[k] = _map_leaf(v)
    return flat


@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_decls_carry_the_reference_axes(arch):
    cfg, rcfg = tcfg.get_config(arch), JCFG.get_config(arch)
    ref = JT.model_decls(rcfg)
    assert _port_flat(T.model_decls(cfg)) == _ref_flat(ref, rcfg)
    assert _port_flat(quantize_model_decls(T.model_decls(cfg))) == \
        _quantized_ref_flat(ref, rcfg)
    for name in ("decode_32k", "long_500k"):
        if not tcfg.cell_supported(arch, name)[0]:
            continue
        s = tcfg.SHAPES[name]
        assert _port_flat(T.cache_decls(cfg, s.global_batch, s.seq_len)) \
            == _ref_layers(JT.cache_decls(rcfg, s.global_batch, s.seq_len),
                           rcfg)
    if arch == "recurrentgemma-2b":   # the sigma-delta references too
        c = dataclasses.replace(cfg, sd_decode_frac=0.25)
        rc = dataclasses.replace(rcfg, sd_decode_frac=0.25)
        assert _port_flat(T.cache_decls(c, 4, 64)) == _ref_layers(
            JT.cache_decls(rc, 4, 64), rc)
    assert T.decl_axes(T.model_decls(cfg))["embed"] == ("p_vocab", "p_embed")


def test_paramdecl_checks_its_axes():
    from repro_torch.models.layers import ParamDecl
    with pytest.raises(ValueError, match="differ in length"):
        ParamDecl((2, 3), ("p_embed",))


# ---------------------------------------------------------------------------
# (b) shapes and cells
# ---------------------------------------------------------------------------

def test_shapes_and_cells_equal_the_reference():
    assert {k: dataclasses.astuple(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JCFG.SHAPES.items()}
    assert list(tcfg.SHAPES) == list(JCFG.SHAPES)
    assert tcfg.LONG_CONTEXT_OK == JCFG.LONG_CONTEXT_OK
    assert list(tcfg.all_cells()) == list(JCFG.all_cells())
    for arch in tcfg.ARCH_IDS:
        for s in tcfg.SHAPES:
            assert tcfg.cell_supported(arch, s) == JCFG.cell_supported(arch,
                                                                        s)
    assert sum(ok for *_, ok, _ in tcfg.all_cells()) == 33


# ---------------------------------------------------------------------------
# (c) state bytes per device
# ---------------------------------------------------------------------------

def _ref_bytes(decls, rules, mesh, dtype=None) -> float:
    total = 0.0
    leaves = jax.tree.leaves(decls, is_leaf=_is_decl)
    for d in leaves:
        spec = rules.spec(d.axes, d.shape, mesh)
        n = 1
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                n *= mesh.shape[a]
        item = np.dtype(dtype if dtype is not None else d.dtype).itemsize
        total += math.prod(d.shape) * item / n
    return total


@pytest.mark.parametrize("shape", MESHES, ids=["single", "multi"])
def test_state_bytes_equal_the_reference(shape):
    mesh = StubMesh(shape)
    multi = len(shape) == 3
    for arch, name, ok, _ in tcfg.all_cells():
        if not ok:
            continue
        cfg, rcfg = tcfg.get_config(arch), JCFG.get_config(arch)
        s = tcfg.SHAPES[name]
        kw = dict(long_context=name == "long_500k", seq_shard=cfg.seq_shard,
                  serve=cfg.serve_rules)
        rules, rrules = default_rules(multi, **kw), JS.default_rules(multi,
                                                                     **kw)
        ref = _ref_bytes(JT.model_decls(rcfg), rrules, mesh)
        state = (SP.param_specs(cfg, mesh, rules),)
        if s.kind == "train":
            mdt = {"float32": np.float32,
                   "bfloat16": jnp.bfloat16}[rcfg.moment_dtype]
            ref += 2 * _ref_bytes(JT.model_decls(rcfg), rrules, mesh,
                                  mdt) + 4        # the int32 step
            state += (SP.opt_specs(cfg, mesh, rules),)
        elif s.kind == "decode":
            ref += _ref_bytes(JT.cache_decls(rcfg, s.global_batch,
                                             s.seq_len), rrules, mesh)
            state += (SP.cache_specs(cfg, mesh, rules, s.global_batch,
                                     s.seq_len),)
        assert SP.state_bytes_per_device(state) == ref, (arch, name, shape)


# ---------------------------------------------------------------------------
# (d), (e) FLOPs
# ---------------------------------------------------------------------------

def _walk(jaxpr, mult=1) -> int:
    """``dot_general`` FLOPs of a jaxpr: scan bodies times their length,
    except an un-unrolled scan under the reference's ``unrolled`` switch
    (its sequence scan), which counts once."""
    from jax.extend import core as jcore
    fl = 0
    for e in jaxpr.eqns:
        name = e.primitive.name
        assert name not in ("cond", "while"), name
        if name == "dot_general":
            (lc, _), _ = e.params["dimension_numbers"]
            if lc:
                k = math.prod(e.invars[0].aval.shape[i] for i in lc)
                fl += mult * 2 * math.prod(e.outvars[0].aval.shape) * k
        m = mult
        if name == "scan" and e.params.get("unroll", 1) != 1:
            m = mult * e.params["length"]
        for v in e.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jcore.ClosedJaxpr):
                    fl += _walk(sub.jaxpr, m)
                elif isinstance(sub, jcore.Jaxpr):
                    fl += _walk(sub, m)
    return fl


def _ref_step_flops(arch, kind, B, S) -> int:
    cfg = JCFG.get_smoke(arch)
    from repro.models.frontend import frontend_feature_shape

    def sds(shp, dt=None):
        return jax.ShapeDtypeStruct(shp, dt or jnp.int32)

    extra = {}
    fs = frontend_feature_shape(cfg, B)
    if fs is not None and kind != "decode":
        extra["frames" if cfg.frontend == "audio" else "patches"] = sds(
            fs, cfg.jdtype)
    key = jax.random.PRNGKey(0)
    with JSU.unrolled(True):
        if kind == "train":
            params, opt = jax.eval_shape(
                lambda: JL.init_train_state(key, cfg))
            step = JL.make_train_step(cfg, JO.warmup_cosine(3e-4, 100,
                                                            10_000),
                                      loss_chunk=512)
            jx = jax.make_jaxpr(step)(
                params, opt, {"tokens": sds((B, S)), "labels": sds((B, S)),
                              **extra})
        else:
            params = jax.eval_shape(lambda: JT.init_model(key, cfg))
            if kind == "prefill":
                jx = jax.make_jaxpr(lambda p, t, e: JT.prefill(
                    p, cfg, t, cache_len=S, **e))(params, sds((B, S)), extra)
            else:
                cache = jax.eval_shape(lambda: JT.init_cache(cfg, B, S))
                jx = jax.make_jaxpr(lambda p, c, t, q: JT.decode_step(
                    p, cfg, c, t, q))(params, cache, sds((B, 1)), sds((B,)))
    return _walk(jx.jaxpr) + JD._recurrence_flops(cfg, kind, B, S)


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_flops_equal_the_cpu_run_and_the_reference(arch, kind):
    cfg = tcfg.get_smoke(arch)
    small = ShapeSpec("small", SMALL_S, SMALL_B, kind)
    rec = D.run_cell(arch, KIND_SHAPE[kind], False, verbose=False,
                     cfg_override=cfg, shape_override=small)
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    # the same step on the CPU with real weights
    fn, args, _ = D.build_step_fn(cfg, small, Mesh((1, 1), AXES, ["cpu"]),
                                  default_rules(False), device="cpu")
    with analysis(), FlopCounterMode(display=False) as fc:
        fn(*args)
    rec_fl = D._recurrence_flops(cfg, kind, SMALL_B, SMALL_S)
    assert rec["flops_global"] == fc.get_total_flops() + rec_fl
    assert rec["flops_per_device"] == rec["flops_global"] / 256
    ref = _ref_step_flops(arch, kind, SMALL_B, SMALL_S)
    if arch == "xlstm-1.3b" and kind == "train":
        assert rec["flops_global"] == pytest.approx(ref,
                                                    rel=XLSTM_TRAIN_RTOL)
    else:
        assert rec["flops_global"] == ref
    assert rec["bytes_global_unfused"] > 0
    assert rec["peak_live_bytes_global"] > 0


@pytest.mark.parametrize("which", ("full", "smoke"))
def test_recurrence_flops_equal_the_reference(which):
    get = {"full": (tcfg.get_config, JCFG.get_config),
           "smoke": (tcfg.get_smoke, JCFG.get_smoke)}[which]
    cfg, rcfg = get[0]("xlstm-1.3b"), get[1]("xlstm-1.3b")
    for s in tcfg.SHAPES.values():
        assert D._recurrence_flops(cfg, s.kind, s.global_batch, s.seq_len) \
            == JD._recurrence_flops(rcfg, s.kind, s.global_batch, s.seq_len)
    assert D._recurrence_flops(cfg, "train", 2, 8) > 0


# ---------------------------------------------------------------------------
# (f) collectives
# ---------------------------------------------------------------------------

def _issued_rows(device, kind):
    cfg = dataclasses.replace(tcfg.get_smoke("olmoe-1b-7b"),
                              moe_impl="shardmap")
    mesh = Mesh((2, 2), AXES, [device] * 4)
    rules = default_rules(False)
    set_mesh_rules(mesh, rules)
    try:
        fn, args, _ = D.build_step_fn(cfg, ShapeSpec("s", 16, 4, kind),
                                      mesh, rules, device=device)
        with col.counting() as rows:
            fn(*args)
    finally:
        clear_mesh_rules()
    return rows


@pytest.mark.parametrize("kind", ("train", "decode"))
def test_issued_collectives_meta_equal_cpu(kind):
    meta, cpu = _issued_rows("meta", kind), _issued_rows("cpu", kind)
    assert meta == cpu
    n_moe = sum(l.ffn == "moe" for l in tcfg.get_smoke("olmoe-1b-7b").layers)
    kinds = [r["kind"] for r in meta]
    assert kinds.count("all-to-all") == 2 * n_moe
    assert {r["op_name"] for r in meta} == {"moe_apply_shardmap"}
    assert all(r["source"] == "issued" and r["count"] == 1 for r in meta)
    for r in meta:
        assert r["wire_bytes"] == r["bytes"] * col.WIRE[r["kind"]](
            r["group"])
    top = H.top_collectives(meta, k=3)
    assert len(top) <= 3 and top[0]["wire_total"] >= top[-1]["wire_total"]
    assert "moe_apply_shardmap" in H.summarize(top)


def test_modelled_collectives_by_hand():
    cfg = tcfg.get_smoke("granite-8b")
    d, H_, Hk, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.d_ff)
    V, L, it = cfg.vocab_padded, cfg.n_layers, cfg.tdtype.itemsize
    mesh = StubMesh((2, 2))
    B = 4
    for kind in ("decode", "train"):
        rows = D.modelled_collectives(cfg, ShapeSpec("s", 16, B, kind), mesh,
                                      default_rules(False))
        passes = 2 + int(cfg.remat) if kind == "train" else 1
        S_act = 1 if kind == "decode" else 16
        # every weight is 2-way FSDP over "data" (d_model divides 2), and
        # the head axes / FFN width split 2-way over "model": a gather
        # brings back the piece times 2, half of it over the wire
        weights = [V * d, d] + ([] if cfg.tie_embeddings else [d * V])
        per_layer = [d, d * H_ * hd, d * Hk * hd, d * Hk * hd, H_ * hd * d,
                     d, d * f, d * f, f * d]
        weights += per_layer * L
        gathers = [r for r in rows if r["kind"] == "all-gather"]
        assert sorted(r["bytes"] for r in gathers) == sorted(
            float(w * it // (4 if w > d else 2) * 2) for w in weights)
        assert all(r["count"] == passes and r["group"] == 2 and
                   r["wire_bytes"] == r["bytes"] / 2 for r in gathers)
        # Megatron: one all-reduce over "model" of the (B/2, S, d)
        # activation after wo and after the FFN down projection
        tp = [r for r in rows if r["op_name"].startswith("tp_all_reduce")]
        assert len(tp) == 2 * L
        assert all(r["bytes"] == B // 2 * S_act * d * it and
                   r["wire_bytes"] == r["bytes"] and r["count"] == passes
                   for r in tp)
        rs = [r for r in rows if r["kind"] == "reduce-scatter"]
        if kind == "train":
            # each gradient reduce-scattered over "data": its piece once
            # per step, (g - 1) x the piece over the wire
            assert sorted(r["bytes"] for r in rs) == sorted(
                float(w * it // (4 if w > d else 2)) for w in weights)
            assert all(r["wire_bytes"] == r["bytes"] for r in rs)
        else:
            assert not rs
        summ = D.summarize_collectives(rows)
        assert summ["total_wire_bytes"] == sum(r["count"] * r["wire_bytes"]
                                               for r in rows)


# ---------------------------------------------------------------------------
# (g) the launchers
# ---------------------------------------------------------------------------

def test_serve_production_lower_writes_a_record(tmp_path, monkeypatch):
    import json
    from repro_torch.launch import serve
    monkeypatch.chdir(tmp_path)
    serve.main(["--production-lower", "--arch", "gemma3-1b", "--shape",
                "decode_32k"])
    path = tmp_path / "experiments" / "dryrun" / \
        "gemma3-1b__decode_32k__single.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["kind"] == "decode" and rec["flops_global"] > 0
    assert rec["collectives"]["total_wire_bytes"] > 0


# ---------------------------------------------------------------------------
# (h) the xLSTM loop outside the switch
# ---------------------------------------------------------------------------

def _plain_mlstm(p, x, n_heads):
    dt = x.dtype
    B, S, _ = x.shape
    xm, z = (x @ p["up"].to(dt)).chunk(2, dim=-1)
    q, k, v, li, lf = TX._mlstm_qkvif(p, xm, n_heads)
    di = xm.shape[-1]
    hd = di // n_heads
    state = (torch.zeros((B, n_heads, hd, hd)), torch.zeros((B, n_heads, hd)),
             torch.zeros((B, n_heads)))
    hs = []
    for t in range(S):
        state, h = TX._mlstm_cell(q[:, t], k[:, t], v[:, t], li[:, t],
                                  lf[:, t], state)
        hs.append(h)
    h = torch.stack(hs, 1).reshape(B, S, di).to(dt)
    return TX._mlstm_out(p, h, z), state


def _plain_slstm(p, x, n_heads):
    dt = x.dtype
    B, S, d = x.shape
    zx, ix, fx, ox = TX._slstm_pre(p, x, n_heads)
    z0 = torch.zeros((B, n_heads, d // n_heads))
    state = (z0, z0, z0, z0)
    hs = []
    for t in range(S):
        state, h = TX._slstm_cell(p, zx[:, t], ix[:, t], fx[:, t], ox[:, t],
                                  state)
        hs.append(h)
    h = torch.stack(hs, 1).reshape(B, S, d).to(dt)
    return h @ p["down"].to(dt), state


def test_xlstm_blocks_bitwise_outside_the_switch():
    from repro_torch.models.layers import init_tree
    gen = torch.Generator().manual_seed(0)
    d, H_, B, S = 32, 2, 2, 12
    x = torch.randn((B, S, d), generator=gen)
    pm = init_tree(gen, TX.mlstm_decls(d, H_), torch.device("cpu"))
    ps = init_tree(gen, TX.slstm_decls(d, H_), torch.device("cpu"))
    y, st = TX.mlstm_block(pm, x, H_)
    y0, st0 = _plain_mlstm(pm, x, H_)
    assert torch.equal(y, y0)
    assert all(torch.equal(st[k], s) for k, s in zip("Cnm", st0))
    y, st = TX.slstm_block(ps, x, H_)
    y0, st0 = _plain_slstm(ps, x, H_)
    assert torch.equal(y, y0)
    assert all(torch.equal(st[k], s) for k, s in zip("cnmh", st0))
    with analysis():           # one step, outputs of the full length
        ya, sta = TX.mlstm_block(pm, x, H_)
        yb, stb = TX.slstm_block(ps, x, H_)
    assert ya.shape == (B, S, d) and yb.shape == (B, S, d)
    assert sta["C"].shape == st0[0].shape[:1] + sta["C"].shape[1:]


# ---------------------------------------------------------------------------
# the paper's own configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ("config", "nmnist", "smoke", "engine"))
def test_sne_dvsgesture_equals_the_reference(fn):
    from repro.configs import sne_dvsgesture as R
    from repro_torch.configs import sne_dvsgesture as P
    assert dataclasses.asdict(getattr(P, fn)()) == \
        dataclasses.asdict(getattr(R, fn)())


def test_param_specs_follow_the_decl_tree():
    # specs hold one Struct a leaf, in the decl tree's order
    cfg = tcfg.get_smoke("gemma3-1b")
    mesh = StubMesh((16, 16))
    ps = SP.param_specs(cfg, mesh, default_rules(False))
    assert [p for p, _ in tree_leaves(ps)] == [
        p for p, _ in tree_leaves(T.model_decls(cfg))]
