"""The port's fused-window pieces against the JAX reference, on the CPU.

* each ``*_window`` plain version (what the wrapper runs for CPU tensors)
  against the reference's ``event_*_window(use_pallas=False)``, under
  both dtype pairings, with no bitmap, an all-ones bitmap and a sparse one
  propagated from events confined to a corner; the pool and conv windows
  also on the gate patterns their CUDA walks are held to on the card;
* the conv window kernel's band rule (``conv_plan``);
* every `kernels.window_common` helper against the reference's, on the
  edges that differ between the two libraries: repeated coordinates in
  ``seed_site_map`` (a max, not an arbitrary writer), a conv padding wider
  than K/2 in ``dilate_conv``, pool remainders, prime geometries;
* ``window_tile_maps`` on ``tiny_net()`` and on a prime-width net;
* the window's edges: a zero-length event axis still leaks; soft-reset
  programs run dense and the kernels refuse explicit bitmaps for them;
  the fusion policy and tile sparsity are part of the program cache key.

The reference runs its ``use_pallas=False`` oracle, never interpret mode.
Every comparison is exact (``np.array_equal``: -0.0 equals +0.0, the only
difference a skipped gated-off event can make).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layer_program as jlp
from repro.core.econv import EConvParams as JParams
from repro.core.econv import EConvSpec as JSpec
from repro.core.lif import LifParams as JLif
from repro.core.policies import ExecutionPolicy as JPolicy
from repro.core.sne_net import SNNSpec as JNet
from repro.core.sne_net import tiny_net as jtiny
from repro.kernels import window_common as jwc
from repro.kernels.event_conv.ops import event_conv_window as jconv_window
from repro.kernels.event_fc.ops import event_fc_window as jfc_window
from repro.kernels.event_pool.ops import event_pool_window as jpool_window
from repro_torch.core import layer_program as lp
from repro_torch.core.econv import EConvParams, EConvSpec
from repro_torch.core.lif import LifParams
from repro_torch.core.policies import ExecutionPolicy
from repro_torch.core.sne_net import SNNSpec, tiny_net
from repro_torch.kernels import window_common as wc
from repro_torch.kernels.event_conv.ops import (BLOCK_SMEM, TARGET_BLOCKS,
                                                conv_plan, conv_smem)
from test_torch_kernels import (GATE_PATTERNS, WINDOW_FNS, pool_walk_case,
                                window_case)

torch.set_num_threads(1)
JAX_WINDOW = {"conv": jconv_window, "pool": jpool_window, "fc": jfc_window}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jlif(lif):
    return JLif(**dataclasses.asdict(lif))


def _eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the three window plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pairing", ["f32", "native"])
@pytest.mark.parametrize("kind,tiles", [
    ("conv", None), ("conv", "ones"), ("conv", "sparse"),
    ("pool", None), ("pool", "ones"), ("pool", "sparse"), ("fc", None)])
def test_window_plain_matches_jax(kind, tiles, pairing):
    v, w, xyc, gate, alive, kw = window_case(kind, pairing, tiles, 3)
    fn, _ = WINDOW_FNS[kind]
    mine = fn(*map(_t, (v, w, xyc, gate, alive)),
              **{k: (_t(x) if k == "tiles" and x is not None else x)
                 for k, x in kw.items()})
    jkw = dict(kw, lif=_jlif(kw["lif"]))
    tiles_j = jkw.pop("tiles", None)

    def jref(*arrays, tiles_j):
        return JAX_WINDOW[kind](*arrays, use_pallas=False, **jkw,
                                **({} if kind == "fc" else {"tiles": tiles_j}))
    ref = jax.jit(jref)(*map(jnp.asarray, (v, w, xyc, gate, alive)),
                        tiles_j=None if tiles_j is None
                        else jnp.asarray(tiles_j))
    for a, b in zip(mine, ref):
        _eq(a, b)
    if tiles == "sparse":       # cold tiles really took the decay path
        assert (mine[1] == 0).any() and mine[1].any()


@pytest.mark.parametrize("pattern", GATE_PATTERNS)
@pytest.mark.parametrize("pairing", ["f32", "native"])
@pytest.mark.parametrize("tiles", ["ones", "sparse"])
def test_pool_window_gate_patterns_match_jax(tiles, pairing, pattern):
    # the gate patterns the CUDA pool walk is held to on the card
    v, w, xyc, gate, alive, kw = pool_walk_case(
        "window", pairing, pattern, 40, 23, tiles=tiles, negative=False)
    mine = WINDOW_FNS["pool"][0](*map(_t, (v, w, xyc, gate, alive)),
                                 **dict(kw, tiles=_t(kw["tiles"])))
    jkw = dict(kw, lif=_jlif(kw["lif"]), tiles=jnp.asarray(kw["tiles"]))
    ref = jpool_window(*map(jnp.asarray, (v, w, xyc, gate, alive)),
                       use_pallas=False, **jkw)
    for a, b in zip(mine, ref):
        _eq(a, b)


@pytest.mark.parametrize("pattern", ["prefix", "empty_slot", "ragged"])
@pytest.mark.parametrize("pairing", ["f32", "native"])
def test_conv_window_gate_patterns_match_jax(pairing, pattern):
    # the gate patterns the CUDA conv walk is held to on the card that lie
    # inside the reference oracle's contract (0/1 gates; channels below
    # Ci, since its jnp.take fills past them): a walk that ends anywhere,
    # holes before the end, an empty slot.  Non-unit gates and clamped
    # coordinates are held kernel against plain version on the card.
    v, w, xyc, gate, alive, kw = window_case("conv", pairing, "ones", 4,
                                             E=40, pattern=pattern)
    mine = WINDOW_FNS["conv"][0](*map(_t, (v, w, xyc, gate, alive)),
                                 **dict(kw, tiles=_t(kw["tiles"])))
    jkw = dict(kw, lif=_jlif(kw["lif"]), tiles=jnp.asarray(kw["tiles"]))
    ref = jconv_window(*map(jnp.asarray, (v, w, xyc, gate, alive)),
                       use_pallas=False, **jkw)
    for a, b in zip(mine, ref):
        _eq(a, b)


@pytest.mark.parametrize("N,geometry,want", [
    (8, (40, 40, 16, 5, 2), (3, 16)),      # Fig. 6 conv1: 14 bands a slot
    (8, (20, 20, 32, 3, 16), (2, 32)),     # Fig. 6 conv2: 10 bands a slot
    (1, (40, 40, 16, 5, 2), (1, 16)),      # one slot: a row a band
    (200, (40, 40, 16, 5, 2), (40, 16)),   # more slots than SMs: one band
    (8, (20, 20, 64, 7, 256), (20, 4)),    # the weights force channel blocks
])
def test_conv_window_plan(N, geometry, want):
    Hp, Wp, Co, K, Ci = geometry
    rows, co_blk = conv_plan(N, Hp, Wp, Co, K, Ci, window=True)
    assert (rows, co_blk) == want
    assert Co % co_blk == 0
    assert conv_smem(rows, Wp, co_blk, K, Ci, window=True) <= BLOCK_SMEM
    # as many blocks as the card has SMs, or the thickest band that fits
    blocks = N * -(-Hp // rows) * (Co // co_blk)
    assert blocks <= max(TARGET_BLOCKS, N * Co // co_blk) or \
        conv_smem(rows + 1, Wp, co_blk, K, Ci, window=True) > BLOCK_SMEM
    with pytest.raises(ValueError, match="does not fit"):
        conv_plan(N, Hp, Wp, Co, 9, 2000, window=True)


# ---------------------------------------------------------------------------
# window_common helpers
# ---------------------------------------------------------------------------

def _site_inputs(rng, T=3, N=2, E=9, H=7, W=5):
    xyc = np.stack([rng.integers(-1, H + 1, (T, N, E)),
                    rng.integers(-1, W + 1, (T, N, E)),
                    rng.integers(0, 2, (T, N, E))], -1).astype(np.int32)
    xyc[1] = xyc[0]                              # coordinates repeat
    gate = (rng.random((T, N, E)) < 0.6).astype(np.float32)
    gate[2, :, 0] = 0.0                          # gated off, repeated
    xyc[2, :, 0] = xyc[0, :, 1]
    return xyc, gate


@pytest.mark.parametrize("helper", [
    "tile_grid", "seed_site_map", "dilate_conv", "dilate_pool",
    "sites_to_tiles", "tiles_to_sites", "cold_tile_decay",
    "pad_empty_schedule", "boundary"])
def test_window_common_matches_jax(helper):
    rng = np.random.default_rng(17)
    site = (rng.random((2, 7, 5)) < 0.2).astype(np.float32)
    if helper == "tile_grid":
        for H, W in [(1, 1), (3, 2), (7, 11), (13, 5), (32, 32), (40, 37)]:
            assert wc.tile_grid(H, W) == jwc.tile_grid(H, W)
    elif helper == "seed_site_map":
        xyc, gate = _site_inputs(rng)
        _eq(wc.seed_site_map(_t(xyc), _t(gate), (7, 5)),
            jwc.seed_site_map(jnp.asarray(xyc), jnp.asarray(gate), (7, 5)))
    elif helper == "dilate_conv":
        for K, P in [(3, 1), (3, 2), (5, 2), (5, 4), (1, 0)]:   # P > K/2
            _eq(wc.dilate_conv(_t(site), K, P),
                jwc.dilate_conv(jnp.asarray(site), K, P))
    elif helper == "dilate_pool":
        for s in (2, 3):
            out = (7 // s, 5 // s)
            _eq(wc.dilate_pool(_t(site), s, out),
                jwc.dilate_pool(jnp.asarray(site), s, out))
    elif helper == "sites_to_tiles":
        for H, W in [(7, 5), (5, 3), (2, 5)]:
            m = site[:, :H, :W]
            grid = wc.tile_grid(H, W)
            _eq(wc.sites_to_tiles(_t(m), grid),
                jwc.sites_to_tiles(jnp.asarray(m), grid))
    elif helper == "tiles_to_sites":
        grid = wc.tile_grid(7, 5)
        tiles = rng.integers(0, 2, (2, grid[0], grid[1])).astype(np.float32)
        _eq(wc.tiles_to_sites(_t(tiles), grid, (7, 5)),
            jwc.tiles_to_sites(jnp.asarray(tiles), grid, (7, 5)))
    elif helper == "cold_tile_decay":
        dt = np.asarray([0, 1, 3], np.int32).reshape(3, 1, 1, 1)
        for lif, v in [
                (LifParams(leak=0.25, state_clip=2.0),
                 (rng.standard_normal((3, 4, 4, 2)) * 3).astype(np.float32)),
                (LifParams(threshold=14.0, leak=2.0, state_clip=127.0,
                           leak_mode="subtract"),
                 rng.integers(-127, 128, (3, 4, 4, 2)).astype(np.int32))]:
            _eq(wc.cold_tile_decay(_t(v), lif, _t(dt)),
                jwc.cold_tile_decay(jnp.asarray(v), _jlif(lif),
                                    jnp.asarray(dt)))
    elif helper == "pad_empty_schedule":
        for E in (0, 2):
            xyc = rng.integers(0, 4, (2, 3, E, 3)).astype(np.int32)
            gate = np.ones((2, 3, E), np.float32)
            for a, b in zip(wc.pad_empty_schedule(_t(xyc), _t(gate)),
                            jwc.pad_empty_schedule(jnp.asarray(xyc),
                                                   jnp.asarray(gate))):
                _eq(a, b)
    else:       # leak, clip/fire/reset and the int8 clamp of one boundary
        for lif, v in [
                (LifParams(leak=0.0625, state_clip=1.5, reset_mode="subtract"),
                 (rng.standard_normal((2, 3, 3, 4)) * 2).astype(np.float32)),
                (LifParams(threshold=14.0, leak=2.0, state_clip=127.0),
                 rng.integers(-300, 300, (2, 3, 3, 4)).astype(np.int32))]:
            jl, jv = _jlif(lif), jnp.asarray(v)
            _eq(wc.leak_boundary(_t(v), lif), jwc.leak_boundary(jv, jl))
            for a, b in zip(wc.clip_fire_reset(_t(v), lif),
                            jwc.clip_fire_reset(jv, jl)):
                _eq(a, b)
            if v.dtype == np.int32:
                _eq(wc.saturate_int8(_t(v)), jwc.saturate_int8(jv))


def test_tile_grid_refuses_an_empty_interior():
    # the reference divides by zero here (ROADMAP Queue C, reference
    # caveats); the port names the geometry
    with pytest.raises(ValueError, match="0 x 5"):
        wc.tile_grid(0, 5)


def _prime_net(reset="zero"):
    lif = LifParams(threshold=1.0, leak=0.0625, reset_mode=reset,
                    state_clip=8.0)
    l1 = EConvSpec("conv", (11, 13, 2), 4, kernel=3, padding=1, lif=lif)
    l2 = EConvSpec("pool", l1.out_shape, 4, kernel=2, stride=2, lif=lif)
    l3 = EConvSpec("conv", l2.out_shape, 3, kernel=3, padding=2, lif=lif)
    l4 = EConvSpec("fc", l3.out_shape, 3, lif=lif)
    return SNNSpec(layers=(l1, l2, l3, l4), n_timesteps=8, n_classes=3)


def _jnet(spec):
    return JNet(layers=tuple(JSpec(**dict(
        dataclasses.asdict(l), lif=_jlif(l.lif))) for l in spec.layers),
        n_timesteps=spec.n_timesteps, n_classes=spec.n_classes)


def _corner_schedule(spec, rng, T=3, N=2, E=6):
    H, W, C = spec.in_shape
    xyc = np.stack([rng.integers(0, max(1, H // 3), (T, N, E)),
                    rng.integers(0, max(1, W // 3), (T, N, E)),
                    rng.integers(0, C, (T, N, E))], -1).astype(np.int32)
    gate = (rng.random((T, N, E)) < 0.75).astype(np.float32)
    return xyc, gate


@pytest.mark.parametrize("net", ["tiny", "prime"])
def test_window_tile_maps_match_jax(net):
    spec = tiny_net() if net == "tiny" else _prime_net()
    jspec = jtiny() if net == "tiny" else _jnet(spec)
    prog = lp.compile_program(spec, device="cpu", policy=ExecutionPolicy())
    jprog = jlp.compile_program(jspec, policy=JPolicy())
    xyc, gate = _corner_schedule(spec, np.random.default_rng(4))
    mine = lp.window_tile_maps(prog, _t(xyc), _t(gate))
    ref = jlp.window_tile_maps(jprog, jnp.asarray(xyc), jnp.asarray(gate))
    assert len(mine) == len(ref) == len(spec.layers)
    for a, b in zip(mine, ref):
        _eq(a, b)
    assert 0 < int(mine[0].sum()) < mine[0].numel()     # genuinely sparse


# ---------------------------------------------------------------------------
# edges of the fused window
# ---------------------------------------------------------------------------

def test_zero_event_axis_still_advances_window():
    """With no events the window still leaks and fires: the padded,
    gated-off schedule equals the per-step executor on zero events."""
    spec = EConvSpec("fc", (2, 2, 1), 2, lif=LifParams(
        threshold=100.0, leak=1.0, state_clip=127.0))
    op = lp.compile_program(SNNSpec(layers=(spec,), n_timesteps=3,
                                    n_classes=2), device="cpu",
                            policy=ExecutionPolicy()).ops[0]
    params = EConvParams(w=torch.ones((4, 2)))
    N, T = 2, 3
    vp = torch.full((N, 1, 1, 2), 40.0)
    alive = torch.ones((N, T))
    vp_ps = vp
    for t in range(T):
        vp_ps, _ = lp.layer_timestep(op, params, vp_ps,
                                     torch.zeros((N, 1, 3), dtype=torch.int32),
                                     torch.zeros((N, 1)), alive[:, t])
    v_f, s_f = lp.layer_window(op, params, vp,
                               torch.zeros((N, T, 0, 3), dtype=torch.int32),
                               torch.zeros((N, T, 0)), alive)
    assert torch.equal(v_f, vp_ps) and not s_f.any()
    assert float(v_f[0, 0, 0, 0]) == 37.0       # 3 steps of leak 1 from 40


def test_soft_reset_runs_dense():
    """A soft-reset program ignores tile sparsity (and equals the per-step
    lowering); the kernels refuse an explicit bitmap under soft reset."""
    spec = _prime_net(reset="subtract")
    prog = lp.compile_program(spec, device="cpu", policy=ExecutionPolicy())
    assert prog.tile_sparsity and not lp.effective_tile_sparsity(prog)
    assert lp.effective_tile_sparsity(
        lp.compile_program(_prime_net(), device="cpu",
                           policy=ExecutionPolicy()))
    rng = np.random.default_rng(2)
    xyc, gate = _corner_schedule(spec, rng, T=3, N=2)
    params = [EConvParams(w=_t((rng.standard_normal(l.weight_shape) * 0.5)
                               .astype(np.float32))) for l in spec.layers]
    out = {}
    for fusion in ("per-step", "fused-window"):
        p = lp.compile_program(spec, device="cpu",
                               policy=ExecutionPolicy(fusion_policy=fusion))
        states = tuple(lp.padded_state(op, n_slots=2) for op in p.ops)
        out[fusion] = lp.window_step(
            params, states, torch.zeros((2, 3)), _t(xyc), _t(gate),
            torch.ones((3, 2)), torch.zeros((2,), dtype=torch.int64),
            program=p)
    for a, b in zip(out["per-step"][0] + out["per-step"][1:],
                    out["fused-window"][0] + out["fused-window"][1:]):
        assert torch.equal(a, b)
    soft = LifParams(reset_mode="subtract")
    for kind in ("conv", "pool"):
        v, w, xyc, gate, alive, kw = window_case(kind, "f32", "ones", 1)
        kw.update(lif=soft, tiles=_t(kw["tiles"]))
        with pytest.raises(ValueError, match="hard-reset"):
            WINDOW_FNS[kind][0](*map(_t, (v, w, xyc, gate, alive)), **kw)


def test_fusion_policy_in_program_cache_key():
    spec = tiny_net()
    progs = {(f, ts): lp.compile_program(
        spec, device="cpu",
        policy=ExecutionPolicy(fusion_policy=f, tile_sparsity=ts))
        for f in ("per-step", "fused-window") for ts in (True, False)}
    assert len({id(p) for p in progs.values()}) == 4
    for (f, ts), p in progs.items():
        assert (p.fusion_policy, p.tile_sparsity) == (f, ts)
    assert lp.compile_program(spec, device="cpu", policy=ExecutionPolicy()) \
        is progs[("fused-window", True)]


def test_layer_window_matches_jax_layer_window():
    """The port's slot-major `layer_window` equals the reference's
    time-major one on a conv layer with a sparse bitmap (both policies'
    weights share the same codes)."""
    spec = _prime_net()
    jspec = _jnet(spec)
    op = lp.compile_program(spec, device="cpu",
                            policy=ExecutionPolicy()).ops[0]
    jop = jlp.compile_program(jspec, policy=JPolicy()).ops[0]
    rng = np.random.default_rng(8)
    xyc, gate = _corner_schedule(spec, rng, T=4, N=3, E=8)
    alive = np.ones((4, 3), np.float32)
    alive[2, 1] = 0.0
    w = (rng.standard_normal(spec.layers[0].weight_shape) * 0.5).astype(
        np.float32)
    Hp, Wp, C = lp.padded_state(op, n_slots=1).shape[1:]
    vp = rng.uniform(-1.0, 0.9, (3, Hp, Wp, C)).astype(np.float32)
    prog = lp.compile_program(spec, device="cpu", policy=ExecutionPolicy())
    tiles = lp.window_tile_maps(prog, _t(xyc), _t(gate))[0]
    mine = lp.layer_window(op, EConvParams(w=_t(w)), _t(vp),
                           _t(xyc.transpose(1, 0, 2, 3)),
                           _t(gate.transpose(1, 0, 2)), _t(alive.T),
                           tiles=tiles)
    ref = jlp.layer_window(jop, JParams(w=jnp.asarray(w)), jnp.asarray(vp),
                           jnp.asarray(xyc), jnp.asarray(gate),
                           jnp.asarray(alive), use_pallas=False,
                           tiles=jnp.asarray(tiles.numpy()))
    _eq(mine[0], ref[0])
    _eq(mine[1], np.transpose(np.asarray(ref[1]), (1, 0, 2, 3, 4)))
