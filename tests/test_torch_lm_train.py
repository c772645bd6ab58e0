"""The port's LM training against the JAX reference, on the CPU.

The reference's training state (``repro.train.loop.init_train_state``
from ``PRNGKey(0)``) crosses over as numpy through
``repro_torch.weights.lm_train_state_from_numpy``; inputs are drawn with
numpy.  Sizes: the smoke configs (float32), B <= 8, S <= 64, loss chunk
16; each JAX function is jitted once per config.

Tolerances:

* the loss and its metrics, ``grad_norm``: ``|port - ref| <= 1e-5 +
  1e-5 |ref|`` (float32, the same operations in the same order; their
  matmul and softmax kernels round differently);
* gradients: every leaf within ``1e-4 * max |ref leaf| + 1e-6``;
* parameters after one and two ``make_train_step`` steps: rtol 2e-2,
  atol 2e-4 at lr 1e-3, the reference's own tolerance between two step
  functions (``tests/test_train_infra.py::test_grad_accum_equals_full_
  batch``): AdamW moves a weight by about ``lr`` a step whatever its
  gradient's size;
* AdamW moments after a train step: within 1e-4 of the leaf's largest
  magnitude in float32 (the gradients' rule); in bfloat16 within 2^-7 of
  it, one bfloat16 step at that scale, since gradients a float32 ulp
  apart may round to neighbouring bfloat16 values; one optimizer update
  from equal inputs: rtol 2^-8 (bfloat16), 1e-6 (float32);
* remat policies, checkpoint resume, the ``lm_ds`` recurrence on JAX's
  draws, checkpoint round trips: bitwise.

The ``gpu`` test (skipped without a card) runs one train step of each
float32 smoke config on the card and on the CPU; it imports no JAX and
runs with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_lm_train.py
"""
import dataclasses
import importlib
import os
import signal

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfg
from repro_torch.data import lm_ds as tds
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.models.frontend import frontend_feature_shape
from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import optimizers as topt
from repro_torch.optim.schedules import constant, warmup_cosine
from repro_torch.train import checkpoint as ck
from repro_torch.train import loop as tloop
from repro_torch.weights import (lm_params_from_numpy,
                                 lm_train_state_from_numpy)

torch.set_num_threads(1)
F32 = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=2e-2, atol=2e-4)
CHUNK = 16


class _Lazy:
    """A module of the reference, imported on first use: the card's
    machine has no JAX, and the gpu test never touches one."""

    def __init__(self, name):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


jax, jnp = _Lazy("jax"), _Lazy("jax.numpy")
JT, JCFG = _Lazy("repro.models.transformer"), _Lazy("repro.configs")
JLOOP, JOPT = _Lazy("repro.train.loop"), _Lazy("repro.optim.optimizers")
JDS, JCK = _Lazy("repro.data.lm_ds"), _Lazy("repro.train.checkpoint")


def _np(x):
    return np.asarray(x.detach().float().cpu().numpy() if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32))


def _close(got, want, tol=F32, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, rng, B=4, S=32, ignore=True):
    """numpy tokens, labels (a few set to -1) and the stub input."""
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    if ignore:
        labels[rng.random((B, S)) < 0.15] = -1
    b = {"tokens": toks, "labels": labels}
    shape = frontend_feature_shape(cfg, B)
    if shape is not None:
        b["frames" if cfg.frontend == "audio" else "patches"] = \
            rng.normal(size=shape).astype(np.float32)
    return b


def _jb(b):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
            for k, v in b.items()}


def _tb(b, dev="cpu"):
    return {k: torch.as_tensor(v).to(dev) for k, v in b.items()}


def _ref_state(arch, **over):
    """The reference's (cfg, params, opt_state) and the port's cfg and
    state carried across."""
    jcfg = dataclasses.replace(JCFG.get_smoke(arch), **over)
    cfg = dataclasses.replace(tcfg.get_smoke(arch), **over)
    jp, jo = JLOOP.init_train_state(jax.random.PRNGKey(0), jcfg)
    tp, to = lm_train_state_from_numpy(_tree_np(jp), _tree_np(jo), cfg,
                                       "cpu")
    return jcfg, cfg, jp, jo, tp, to


def _port_grads(params, cfg, batch, chunk=CHUNK):
    loss, _, grads = tloop.loss_and_grads(tloop.make_loss_fn(cfg, chunk),
                                          params, batch)
    return loss, tree_unflatten(params, grads)


def _grads_close(got, want, what):
    """Every leaf within 1e-4 of the reference leaf's largest magnitude
    plus 1e-6."""
    gl, wl = list(tree_leaves(got)), list(tree_leaves(want))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        w = _np(w)
        tol = 1e-4 * float(np.abs(w).max()) + 1e-6
        err = float(np.abs(_np(g) - w).max())
        assert err <= tol, f"{what} {path}: {err:.3e} > {tol:.3e}"


# ---------------------------------------------------------------------------
# The repaired checkpoint: dict trees, bfloat16 leaves
# ---------------------------------------------------------------------------

def _dict_tree(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return {"embed": torch.randn(6, 4, generator=g).to(dtype),
            "layers": [{"attn": {"wq": torch.randn(4, 4, generator=g)
                                 .to(dtype)},
                        "norm": torch.zeros(4, dtype=dtype)}
                       for _ in range(2)],
            "count": torch.arange(3, dtype=torch.int32)}


def test_checkpoint_nests_dicts_named_as_the_reference(tmp_path):
    """A tuple of a dict tree and an ``AdamWState`` of dict moments: the
    leaf names equal the reference's paths for the same tree, and the
    round trip is bitwise with the dict keys in their own order."""
    p = _dict_tree()
    st = topt.AdamWState(torch.tensor(3, dtype=torch.int32),
                         tree_map(torch.ones_like, p),
                         tree_map(torch.zeros_like, p))
    path = ck.save(str(tmp_path), 5, (p, st), extras={"next_step": 5})
    names = [n for n, _ in ck._flatten((p, st))]
    jtree = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                         (p, JOPT.AdamWState(*st)))
    assert names == [n for n, _ in JCK._flatten(jtree)]
    assert "0/layers/1/attn/wq" in names and "1/mu/layers/0/norm" in names
    assert len(os.listdir(path)) == len(names) + 1
    target = (tree_map(torch.empty_like, p), topt.AdamWState(
        torch.tensor(0, dtype=torch.int32), tree_map(torch.empty_like, p),
        tree_map(torch.empty_like, p)))
    (rp, rst), extras = ck.restore(str(tmp_path), 5, target)
    assert extras == {"next_step": 5} and isinstance(rst, topt.AdamWState)
    assert list(rp) == list(p) and list(rp["layers"][0]) == ["attn", "norm"]
    for (na, a), (nb, b) in zip(ck._flatten((p, st)),
                                ck._flatten((rp, rst))):
        assert na == nb and a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_bfloat16_round_trip_is_bitwise(tmp_path):
    p = _dict_tree(torch.bfloat16)
    odd = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                        1e-40, 3.0e38, -1.5e-3], dtype=torch.bfloat16)
    tree = {"p": p, "odd": odd, "scalar": torch.tensor(2.5,
                                                       dtype=torch.bfloat16)}
    ck.save(str(tmp_path), 1, tree)
    import json
    with open(os.path.join(tmp_path, "step_00000001", "manifest.json")) as f:
        dtypes = {l["name"]: l["dtype"] for l in json.load(f)["leaves"]}
    assert dtypes["odd"] == "bfloat16" and dtypes["p/count"] == "int32"
    got, _ = ck.restore(str(tmp_path), 1, tree_map(torch.zeros_like, tree))
    for (_, a), (_, b) in zip(tree_leaves(tree), tree_leaves(got)):
        assert b.dtype == a.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


def test_checkpoint_refuses_shape_and_missing_leaves_keeps_last_k(tmp_path):
    ck.save(str(tmp_path), 0, {"x": torch.zeros(2)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(str(tmp_path), 0, {"x": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore(str(tmp_path), 0, {"y": torch.zeros(2)})
    for s in range(1, 6):
        ck.save(str(tmp_path), s, {"x": torch.full((2,), float(s))},
                keep_last=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000004", "step_00000005"]
    assert ck.latest(str(tmp_path)) == 5
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


# ---------------------------------------------------------------------------
# AdamW's moment dtype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moment", ["bfloat16", "float32"])
def test_adamw_moment_dtype_matches_the_reference(moment):
    """One step from the same numpy inputs: params at rtol 1e-6; the
    moments in their own dtype, float32 at rtol 1e-6, bfloat16 within one
    rounding step; ``adamw_init`` makes zeros of that dtype."""
    rng = np.random.default_rng(3)
    shapes = [(7, 5), (5,), (3, 4, 2)]
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    gs = [(rng.standard_normal(s) * 2.0).astype(np.float32) for s in shapes]
    mus = [(rng.standard_normal(s) * 0.1).astype(np.float32) for s in shapes]
    nus = [(rng.random(s) * 0.01).astype(np.float32) for s in shapes]
    jdt, tdt = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
                "float32": (jnp.float32, torch.float32)}[moment]
    st = topt.adamw_init([torch.as_tensor(p) for p in ps], tdt)
    assert all(m.dtype == tdt and not m.any() for m in st.mu + st.nu)
    jn, js, jm = JOPT.adamw_update(
        [jnp.asarray(g) for g in gs],
        JOPT.AdamWState(jnp.asarray(np.int32(4)),
                        [jnp.asarray(m, jdt) for m in mus],
                        [jnp.asarray(n, jdt) for n in nus]),
        [jnp.asarray(p) for p in ps], jnp.asarray(np.float32(1e-3)))
    tn, ts, tm = topt.adamw_update(
        [torch.as_tensor(g) for g in gs],
        topt.AdamWState(torch.tensor(4, dtype=torch.int32),
                        [torch.as_tensor(m).to(tdt) for m in mus],
                        [torch.as_tensor(n).to(tdt) for n in nus]),
        [torch.as_tensor(p) for p in ps], torch.tensor(1e-3))
    _close(tm["grad_norm"], jm["grad_norm"], dict(rtol=1e-6, atol=0))
    for a, b in zip(tn, jn):
        _close(a, b, dict(rtol=1e-6, atol=1e-9))
    mtol = (dict(rtol=2.0 ** -8, atol=0) if moment == "bfloat16"
            else dict(rtol=1e-6, atol=1e-9))
    for a, b in zip(ts.mu + ts.nu, js.mu + js.nu):
        assert a.dtype == tdt
        _close(a, np.asarray(b, np.float32), mtol)


# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vp", [False, True])
@pytest.mark.parametrize("arch", ["granite-8b", "gemma3-1b"])
def test_lm_loss_matches_the_reference(arch, vp):
    """granite (untied) and gemma3 (tied), both CE forms, labels < 0
    ignored: the loss and every metric."""
    jcfg = dataclasses.replace(JCFG.get_smoke(arch), vp_loss=vp)
    cfg = dataclasses.replace(tcfg.get_smoke(arch), vp_loss=vp)
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(_tree_np(jp), cfg, "cpu")
    b = _batch(cfg, np.random.default_rng(1))
    jl, jm = jax.jit(lambda p, t, l: JT.lm_loss(p, jcfg, t, l,
                                                loss_chunk=CHUNK))(
        jp, *_jb(b).values())
    tl, tm = T.lm_loss(tp, cfg, *_tb(b).values(), loss_chunk=CHUNK)
    _close(tl, jl)
    assert set(tm) == set(jm) == {"ce", "aux_loss", "moe_dropped", "tokens"}
    for k in tm:
        _close(tm[k], jm[k], what=k)
    assert float(tm["tokens"]) == float((b["labels"] >= 0).sum()) < b[
        "labels"].size


def test_lm_loss_all_labels_ignored_and_chunk_must_divide():
    cfg = tcfg.get_smoke("granite-8b")
    p = T.init_model(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.zeros((2, 32), dtype=torch.long)
    loss, m = T.lm_loss(p, cfg, toks, torch.full((2, 32), -1), loss_chunk=16)
    assert float(loss) == 0.0 and float(m["tokens"]) == 0.0
    with pytest.raises(AssertionError, match="multiple"):
        T.lm_loss(p, cfg, toks, toks, loss_chunk=12)


@pytest.mark.parametrize("arch", tcfg.ARCH_IDS)
def test_loss_gradients_match_jax_grad(arch):
    """The gradient of ``lm_loss`` against ``jax.grad`` of the
    reference's, every leaf (the reference's unstacked by
    ``lm_params_from_numpy``)."""
    jcfg, cfg = JCFG.get_smoke(arch), tcfg.get_smoke(arch)
    jp = JT.init_model(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(_tree_np(jp), cfg, "cpu")
    b = _batch(cfg, np.random.default_rng(2), B=2)

    def jloss(p, batch):
        return JLOOP.make_loss_fn(jcfg, CHUNK)(p, batch)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp, _jb(b))
    tl, tg = _port_grads(tp, cfg, _tb(b))
    _close(tl, jl)
    _grads_close(tg, lm_params_from_numpy(_tree_np(jg), cfg, "cpu"), arch)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,over", [
    ("granite-8b", {}),
    ("granite-8b", {"grad_accum": 4}),
    ("llama4-maverick-400b-a17b", {"grad_accum": 2,
                                   "moment_dtype": "bfloat16",
                                   "grad_dtype": "bfloat16"}),
], ids=["granite", "granite-accum4", "llama4-bf16-moments"])
def test_train_step_matches_the_reference(arch, over):
    """Two steps of ``make_train_step`` from the same state on the same
    batches: loss, grad_norm and the other metrics, then the params (and
    moments, in their own dtype) after each step."""
    jcfg, cfg, jp, jo, tp, to = _ref_state(arch, **over)
    mdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        cfg.moment_dtype]
    assert all(m.dtype == mdt for _, m in tree_leaves(to.mu))
    jstep = jax.jit(JLOOP.make_train_step(jcfg, lambda s: 1e-3,
                                          loss_chunk=CHUNK))
    tstep = tloop.make_train_step(cfg, constant(1e-3), loss_chunk=CHUNK)
    rng = np.random.default_rng(4)
    for i in range(2):
        b = _batch(cfg, rng, B=8)
        jp, jo, jm = jstep(jp, jo, _jb(b))
        tp, to, tm = tstep(tp, to, _tb(b))
        assert set(tm) == set(jm)
        for k in ("loss", "grad_norm", "ce", "aux_loss", "lr", "tokens"):
            _close(tm[k], jm[k], what=f"step {i} {k}")
        assert int(to.step) == int(jo.step) == i + 1
        want = lm_params_from_numpy(_tree_np(jp), cfg, "cpu")
        for (path, a), (_, w) in zip(tree_leaves(tp), tree_leaves(want)):
            _close(a, w, STEP_TOL, f"step {i} {path}")
        mom = lm_train_state_from_numpy(_tree_np(jp), _tree_np(jo), cfg,
                                        "cpu")[1]
        for got, want in ((to.mu, mom.mu), (to.nu, mom.nu)):
            for (path, a), (_, w) in zip(tree_leaves(got),
                                         tree_leaves(want)):
                assert a.dtype == mdt
                rel = 1e-4 if mdt == torch.float32 else 2.0 ** -7
                scale = float(np.abs(_np(w)).max())
                _close(a, w, dict(rtol=0, atol=rel * scale + 1e-12),
                       f"step {i} moment {path}")


def test_grad_accum_equals_one_batch_in_the_port():
    """accum 4 over B = 8 against accum 1 over the same batch, at the
    reference's tolerance (loss within 1e-3, params rtol 2e-2 / atol
    2e-4)."""
    cfg = tcfg.get_smoke("granite-8b")
    b = _tb(_batch(cfg, np.random.default_rng(5), B=8, ignore=False))
    p, o = tloop.init_train_state(torch.Generator().manual_seed(0), cfg,
                                  "cpu")
    p1, _, m1 = tloop.make_train_step(cfg, constant(1e-3), CHUNK)(p, o, b)
    cfg4 = dataclasses.replace(cfg, grad_accum=4)
    p4, _, m4 = tloop.make_train_step(cfg4, constant(1e-3), CHUNK)(p, o, b)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 1e-3
    for (path, a), (_, c) in zip(tree_leaves(p1), tree_leaves(p4)):
        _close(a, c, STEP_TOL, path)


@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b"])
def test_remat_policies_are_bitwise_equal(arch):
    """remat off, ``"full"`` and ``"boundaries"``: one step each from the
    same state, everything bitwise, on four threads (the embedding's
    backward must sum in one order however many threads the CPU runs)."""
    base = tcfg.get_smoke(arch)
    b = _tb(_batch(base, np.random.default_rng(6), B=8))
    p, o = tloop.init_train_state(torch.Generator().manual_seed(0), base,
                                  "cpu")
    runs = []
    torch.set_num_threads(4)
    try:
        for remat, policy in ((False, "full"), (True, "full"),
                              (True, "boundaries")):
            cfg = dataclasses.replace(base, remat=remat,
                                      remat_policy=policy)
            runs.append(tloop.make_train_step(cfg, constant(1e-3), CHUNK)(
                p, o, b))
    finally:
        torch.set_num_threads(1)
    (p0, o0, m0) = runs[0]
    for p1, o1, m1 in runs[1:]:
        assert all(torch.equal(m0[k], m1[k]) for k in m0)
        for (_, a), (_, c) in zip(tree_leaves([p0, o0.mu, o0.nu]),
                                  tree_leaves([p1, o1.mu, o1.nu])):
            assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# The token pipeline
# ---------------------------------------------------------------------------

def test_bigram_recurrence_matches_the_reference_on_its_draws():
    """The reference's draws (its keys, as its ``batch_at`` splits them)
    through the port's recurrence: tokens and labels bitwise."""
    spec = tds.LmDatasetSpec(vocab_size=977, seq_len=40)
    jspec = JDS.LmDatasetSpec(vocab_size=977, seq_len=40)
    for seed, index, shard, n_shards in ((7, 3, 0, 1), (2, 11, 1, 2)):
        rows = 8 // n_shards
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(seed), index), shard)
        k0, k1, k2 = jax.random.split(key, 3)
        first = jax.random.randint(k0, (rows, 1), 0, 977)
        noise = jax.random.randint(k1, (rows, 40), 0, 977)
        use = jax.random.uniform(k2, (rows, 40)) < jspec.p_struct
        toks, labels = tds.bigram(
            spec, torch.as_tensor(np.asarray(first)).long(),
            torch.as_tensor(np.asarray(noise)).long(),
            torch.as_tensor(np.asarray(use)))
        jt, jl = JDS.batch_at(jspec, seed, index, 8, shard, n_shards)
        np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
        assert 0 < (~np.asarray(use)).sum()


def test_batch_at_is_deterministic_sharded_and_aligned():
    ds = tds.LmDatasetSpec(vocab_size=977, seq_len=32)
    t1, l1 = tds.batch_at(ds, 7, 3, 8, device="cpu")
    t2, l2 = tds.batch_at(ds, 7, 3, 8, device="cpu")
    assert torch.equal(t1, t2) and torch.equal(l1, l2)
    assert t1.shape == l1.shape == (8, 32) and t1.dtype == torch.int64
    assert not torch.equal(t1, tds.batch_at(ds, 7, 4, 8, device="cpu")[0])
    assert not torch.equal(t1, tds.batch_at(ds, 8, 3, 8, device="cpu")[0])
    s0, _ = tds.batch_at(ds, 7, 3, 8, shard=0, n_shards=2, device="cpu")
    s1, _ = tds.batch_at(ds, 7, 3, 8, shard=1, n_shards=2, device="cpu")
    assert s0.shape == (4, 32) and not torch.equal(s0, s1)
    assert bool((l1[:, :-1] == t1[:, 1:]).all())
    assert int(t1.min()) >= 0 and int(t1.max()) < 977
    # the structure is there: most labels follow the affine rule
    follows = (l1 == (31 * t1 + 17) % 977).float().mean()
    assert 0.8 < float(follows) < 1.0
    it = tds.stream(ds, 7, 8, start_index=3, device="cpu")
    assert torch.equal(next(it)[0], t1) and torch.equal(
        next(it)[0], tds.batch_at(ds, 7, 4, 8, device="cpu")[0])


# ---------------------------------------------------------------------------
# train_loop and the launcher
# ---------------------------------------------------------------------------

def _batches(cfg, start=0, kill_at=None):
    ds = tds.LmDatasetSpec(vocab_size=cfg.vocab_size, seq_len=16)
    for i, (t, l) in enumerate(tds.stream(ds, 0, 4, start_index=start,
                                          device="cpu"), start):
        if i == kill_at:
            os.kill(os.getpid(), signal.SIGTERM)
        yield {"tokens": t, "labels": l}


def test_train_loop_resume_is_bitwise(tmp_path):
    """6 steps with checkpoints every 3; the step-6 checkpoint deleted and
    the run resumed from step 3: losses 3-5, params and moments
    bitwise."""
    import shutil
    cfg = tcfg.get_smoke("granite-8b")
    sched = warmup_cosine(1e-3, 2, 6)
    kw = dict(seed=0, ckpt_dir=str(tmp_path), ckpt_every=3, loss_chunk=16,
              log_fn=lambda s: None, device="cpu")
    full = tloop.train_loop(cfg, _batches(cfg), 6, sched, **kw)
    assert ck.latest(str(tmp_path)) == 6 and len(full["history"]) == 6
    shutil.rmtree(tmp_path / "step_00000006")
    logs = []
    res = tloop.train_loop(cfg, _batches(cfg, start=3), 6, sched,
                           **dict(kw, log_fn=logs.append))
    assert "restored step 3 -> resuming at 3" in logs[0]
    assert [h["loss"] for h in res["history"]] == [
        h["loss"] for h in full["history"][3:]]
    assert all(np.isfinite(h["loss"]) for h in full["history"])
    assert int(res["opt_state"].step) == 6
    for (_, a), (_, b) in zip(
            tree_leaves([full["params"], full["opt_state"].mu,
                         full["opt_state"].nu]),
            tree_leaves([res["params"], res["opt_state"].mu,
                         res["opt_state"].nu])):
        assert torch.equal(a, b)


def test_train_loop_sigterm_checkpoints_and_exits(tmp_path):
    cfg = tcfg.get_smoke("granite-8b")
    before = signal.getsignal(signal.SIGTERM)
    logs = []
    out = tloop.train_loop(cfg, _batches(cfg, kill_at=1), 10,
                           constant(1e-3), ckpt_dir=str(tmp_path),
                           ckpt_every=100, loss_chunk=16, log_fn=logs.append,
                           device="cpu")
    assert len(out["history"]) == 2
    assert ck.latest(str(tmp_path)) == 2
    assert "exiting cleanly" in logs[-1]
    assert signal.getsignal(signal.SIGTERM) == before


def test_granite_smoke_learns():
    """The reference's ``test_lm_training_learns`` on the port: 60 steps
    of B = 8, S = 32 on the structured bigram data; the loss must fall by
    more than 1.0."""
    cfg = tcfg.get_smoke("granite-8b")
    ds = tds.LmDatasetSpec(vocab_size=cfg.vocab_size, seq_len=32)
    params, opt = tloop.init_train_state(torch.Generator().manual_seed(0),
                                         cfg, "cpu")
    step = tloop.make_train_step(cfg, warmup_cosine(3e-3, 5, 60),
                                 loss_chunk=16)
    losses = []
    for i in range(60):
        t, l = tds.batch_at(ds, 0, i, 8, device="cpu")
        params, opt, m = step(params, opt, {"tokens": t, "labels": l})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


@pytest.mark.parametrize("arch", ["gemma3-1b", "whisper-medium"])
def test_launcher_trains_on_the_cpu(arch, tmp_path, capsys):
    out = launch_train.main(["--arch", arch, "--smoke", "--steps", "3",
                             "--seq", "32", "--batch", "4", "--device", "cpu",
                             "--ckpt-dir", str(tmp_path), "--ckpt-every",
                             "2"])
    assert len(out["history"]) == 3
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert ck.latest(str(tmp_path)) == 3
    assert "[train] first loss" in capsys.readouterr().out


def test_launcher_production_lower_is_refused(tmp_path, monkeypatch):
    # --production-lower is the dry-run's train_4k cell now (it was
    # refused before the dry-run was ported); the cell itself is held in
    # tests/test_torch_dryrun.py, so a stub stands in for it here
    from repro_torch.launch import dryrun
    calls = []

    def run_cell(arch, shape_name, multi_pod, **kw):
        calls.append((arch, shape_name, multi_pod))
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "tag": "", "status": "ok"}

    monkeypatch.setattr(dryrun, "run_cell", run_cell)
    monkeypatch.chdir(tmp_path)
    rec = launch_train.main(["--arch", "gemma3-1b", "--production-lower",
                             "--device", "cpu"])
    assert calls == [("gemma3-1b", "train_4k", False)]
    assert rec["status"] == "ok"
    assert (tmp_path / "experiments" / "dryrun" /
            "gemma3-1b__train_4k__single.json").exists()


# ---------------------------------------------------------------------------
# On the card (skipped without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_train_step_matches_cpu(cuda):
    """One ``make_train_step`` of every float32 smoke config on the card
    and on the CPU from the same weights and batch, TF32 off: loss and
    grad_norm within 1e-5 relative, every gradient leaf within 1e-4 of
    its largest magnitude plus 1e-6, MoE's dropped fraction equal."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for arch in tcfg.ARCH_IDS:
            cfg = tcfg.get_smoke(arch)
            p, o = tloop.init_train_state(torch.Generator().manual_seed(0),
                                          cfg, "cpu")
            b = _batch(cfg, np.random.default_rng(7), B=4)
            step = tloop.make_train_step(cfg, constant(1e-3), CHUNK)
            out = {}
            for dev in ("cpu", cuda):
                pd = tree_map(lambda t: t.to(dev), p)
                od = topt.AdamWState(o.step.to(dev),
                                     tree_map(lambda t: t.to(dev), o.mu),
                                     tree_map(lambda t: t.to(dev), o.nu))
                grads = _port_grads(pd, cfg, _tb(b, dev))[1]
                out[str(dev)] = (grads, step(pd, od, _tb(b, dev))[2])
            (cg, cm), (gg, gm) = out["cpu"], out[str(cuda)]
            for k in ("loss", "grad_norm"):
                _close(gm[k], cm[k], dict(rtol=1e-5, atol=0), f"{arch} {k}")
            assert float(gm["moe_dropped"]) == float(cm["moe_dropped"])
            _grads_close(gg, cg, f"{arch} card vs CPU")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
