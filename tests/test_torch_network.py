"""The port's fused-network lowering against the JAX reference, on the CPU.

* ``window_common.route_frame`` against the reference's, under-full,
  exactly full and over-full frames, and a cap past the frame's sites;
* the plain ``network_window_ref`` (what the wrapper runs for CPU
  tensors) against the reference's ``network_window_ref`` on the inputs
  ``test_torch_kernels.network_case`` builds: both dtype policies, dense
  and with sparse tile bitmaps, random liveness, routing overflow;
* ``window_step`` under ``"fused-network"`` against the reference's
  (``use_pallas=False``) and against the port's own fused-window lowering,
  two windows back to back with a deferred idle decay;
* the plan the fallback rule reads: one CTA's share of every layer
  (``smem_layout``, the launch's own), its fields add up, Fig. 6 fits the
  H100's budget per CTA under both policies, and a budget too small warns
  and runs fused-window with the same bits.

The served cohort under fused-network is held against the live JAX engine
in ``test_torch_serve.py``.  The reference runs its ``use_pallas=False``
oracle, never interpret mode; every comparison is exact
(``np.array_equal``: -0.0 equals +0.0, the only difference a skipped
gated-off event can make).
"""
import dataclasses
import functools

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
from repro.kernels import window_common as jwc
from repro.kernels.network_window.ref import \
    network_window_ref as jnetwork_window_ref
from repro_torch.core import layer_program as lp
from repro_torch.core.econv import EConvParams
from repro_torch.core.policies import ExecutionPolicy
from repro_torch.core.quant import quantize_net
from repro_torch.core.sne_net import dvs_gesture_net, init_snn
from repro_torch.kernels import network_window as nw
from repro_torch.kernels.window_common import route_frame
from test_torch_kernels import NETWORK_CAPS, network_case

torch.set_num_threads(1)
POLICIES = ["f32-carrier", "int8-native"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _jnet(spec):
    """The reference's spec of the port's (the same numbers)."""
    return JNet(layers=tuple(JSpec(**dict(
        dataclasses.asdict(l), lif=JLif(**dataclasses.asdict(l.lif))))
        for l in spec.layers), n_timesteps=spec.n_timesteps,
        n_classes=spec.n_classes)


def _jprog(prog, fusion="fused-network", tile_sparsity=True):
    return jlp.compile_program(
        _jnet(prog.spec), step_capacities=prog.step_capacities,
        policy=JPolicy(dtype_policy=prog.dtype_policy, fusion_policy=fusion,
                       tile_sparsity=tile_sparsity))


# ---------------------------------------------------------------------------
# route_frame
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("cap,fill", [
    (8, 5), (8, 8), (8, 17), (13, 4), (13, 13), (13, 20), (40, 19)])
def test_route_frame_matches_jax(cap, fill, dtype):
    """``fill`` spiking sites of a (3, 4, 2) frame (24 sites): under-full,
    exactly full, over-full; cap 40 is past the frame and clamps to it."""
    rng = np.random.default_rng(cap * 100 + fill)
    s = np.zeros(24, dtype)
    s[rng.choice(24, fill, replace=False)] = 1
    s = s.reshape(3, 4, 2)
    got = route_frame(_t(s), cap)
    want = jwc.route_frame(jnp.asarray(s), cap)
    for g, w in zip(got, want):
        _eq(g, w)
    assert got[0].shape == (min(cap, 24), 3)
    assert int(got[2]) == max(fill - min(cap, 24), 0)
    assert int(got[1].sum()) == min(fill, cap)


# ---------------------------------------------------------------------------
# the plain fused-network window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiles", [None, "sparse"])
@pytest.mark.parametrize("pairing", ["f32", "native"])
@pytest.mark.parametrize("net", ["tiny", "mini"])
def test_network_window_plain_matches_jax(net, pairing, tiles):
    prog, states, weights, xyc, gate, alive, bitmaps = network_case(
        net, pairing, tiles, 3, T=3)
    native = pairing == "native"
    mine = nw.network_window(
        [_t(v) for v in states], [_t(w) for w in weights], _t(xyc),
        _t(gate), _t(alive), layers=lp._net_layers(prog), native=native,
        tiles=None if bitmaps is None else [_t(b) for b in bitmaps])
    ref = jax.jit(functools.partial(
        jnetwork_window_ref, layers=jlp._net_layers(_jprog(prog)),
        native=native))(
        tuple(map(jnp.asarray, states)), tuple(map(jnp.asarray, weights)),
        jnp.asarray(xyc), jnp.asarray(gate), jnp.asarray(alive),
        tiles=None if bitmaps is None else tuple(map(jnp.asarray, bitmaps)))
    for a, b in zip(mine[0], ref[0]):
        _eq(a, b)
    for a, b in zip(mine[1:], ref[1:]):
        _eq(a, b)
    counts, drops = mine[2].numpy(), mine[3].numpy()
    assert (counts[:, 0] > 0).all()
    if tiles is None:
        assert (counts > 0).all()              # every layer took events
        assert drops[:, 1:].sum() > 0          # and a boundary overflowed
        assert mine[1].any()


def test_network_window_refuses_bitmaps_under_soft_reset():
    prog, states, weights, xyc, gate, alive, bitmaps = network_case(
        "mini", "f32", "sparse", 4)
    soft = tuple(dataclasses.replace(nl, lif=dataclasses.replace(
        nl.lif, reset_mode="subtract")) for nl in lp._net_layers(prog))
    with pytest.raises(ValueError, match="hard-reset"):
        nw.network_window([_t(v) for v in states], [_t(w) for w in weights],
                          _t(xyc), _t(gate), _t(alive), layers=soft,
                          tiles=[_t(b) for b in bitmaps])


def test_network_window_refuses_a_plan_that_disagrees():
    prog, states, weights, xyc, gate, alive, _ = network_case(
        "mini", "f32", None, 4)
    layers = lp._net_layers(prog)
    bad = layers[:2] + (dataclasses.replace(layers[2], in_shape=(9, 9, 4)),
                        ) + layers[3:]
    with pytest.raises(ValueError, match="takes"):
        nw.network_window([_t(v) for v in states], [_t(w) for w in weights],
                          _t(xyc), _t(gate), _t(alive), layers=bad)


# ---------------------------------------------------------------------------
# window_step under fused-network
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile_sparsity", [True, False])
@pytest.mark.parametrize("dtype_policy", POLICIES)
@pytest.mark.parametrize("net", ["tiny", "mini"])
def test_window_step_network_matches_jax_and_fused_window(net, dtype_policy,
                                                           tile_sparsity):
    pairing = "native" if dtype_policy == "int8-native" else "f32"
    prog, states, weights, xyc, gate, _, _ = network_case(
        net, pairing, "sparse" if tile_sparsity else None, 5, T=3)
    pol = ExecutionPolicy(dtype_policy=dtype_policy,
                          fusion_policy="fused-network",
                          tile_sparsity=tile_sparsity)
    prog = lp.compile_program(prog.spec, NETWORK_CAPS[net], pol,
                              device="cpu")
    fw_prog = lp.compile_program(prog.spec, NETWORK_CAPS[net],
                                 dataclasses.replace(
                                     pol, fusion_policy="fused-window"),
                                 device="cpu")
    assert lp.effective_fusion(prog) == "fused-network"
    jprog = _jprog(prog, tile_sparsity=tile_sparsity)
    params = [EConvParams(w=_t(w)) for w in weights]
    jparams = [JParams(w=jnp.asarray(w)) for w in weights]
    # back to time-major, layer coordinates, as the collector gives them
    op0 = prog.ops[0]
    pad = op0.spec.padding if op0.kind == "conv" else 0
    xyc = xyc.transpose(1, 0, 2, 3) - np.asarray([pad, pad, 0], np.int32)
    gate = gate.transpose(1, 0, 2)
    N = xyc.shape[1]
    alive = np.ones((xyc.shape[0], N), np.float32)
    alive[2:, 2] = 0.0                            # slot 2 frozen mid-window
    cc = np.zeros((N, prog.spec.n_classes), np.float32)
    jstep = jax.jit(functools.partial(jlp.window_step, program=jprog,
                                      use_pallas=False))
    t_run = (tuple(map(_t, states)), _t(cc))
    f_run = t_run
    j_run = (tuple(map(jnp.asarray, states)), jnp.asarray(cc))
    for window in range(2):
        pre = np.asarray([0, 2, 1], np.int64) if window == 0 else \
            np.zeros(N, np.int64)
        args = (_t(xyc), _t(gate), _t(alive), _t(pre))
        mine = lp.window_step(params, *t_run, *args, program=prog)
        fused = lp.window_step(params, *f_run, *args, program=fw_prog)
        ref = jstep(jparams, *j_run, *map(jnp.asarray,
                                          (xyc, gate, alive, pre)))
        for a, b, c in zip(mine[0] + mine[1:], fused[0] + fused[1:],
                           ref[0] + ref[1:]):
            assert torch.equal(a, b)
            _eq(a, c)
        t_run, f_run, j_run = mine[:2], fused[:2], ref[:2]
    if not tile_sparsity:
        assert float(mine[2][-1].sum()) > 0       # spikes reached the head


def test_undersized_budget_warns_and_stays_bitwise(monkeypatch):
    prog, states, weights, xyc, gate, alive, _ = network_case(
        "mini", "f32", None, 6)
    fw_prog = lp.compile_program(prog.spec, NETWORK_CAPS["mini"],
                                 ExecutionPolicy(), device="cpu")
    plan = lp.network_window_plan(prog)
    monkeypatch.setattr(lp, "SMEM_BUDGET", plan.smem_bytes)
    assert lp.effective_fusion(prog) == "fused-network"
    monkeypatch.setattr(lp, "SMEM_BUDGET", plan.smem_bytes - 1)
    assert lp.effective_fusion(prog) == "fused-window"
    params = [EConvParams(w=_t(w)) for w in weights]
    N = xyc.shape[0]
    args = (tuple(map(_t, states)),
            torch.zeros((N, prog.spec.n_classes)),
            _t(xyc.transpose(1, 0, 2, 3)), _t(gate.transpose(1, 0, 2)),
            _t(alive.T), torch.zeros((N,), dtype=torch.int64))
    with pytest.warns(UserWarning, match="falling back to the fused-window"):
        got = lp.window_step(params, *args, program=prog)
    want = lp.window_step(params, *args, program=fw_prog)
    for a, b in zip(got[0] + got[1:], want[0] + want[1:]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

# (owned sites, hot-bit words, frame sites) of the widest CTA share of
# each layer, by hand, rows dealt to the 8 CTAs in turn: tiny conv 16 slab
# rows -> 2 a CTA of 16 columns x 6 channels, a word of hot bits a row, of
# its 12 frame rows at most 2; pool 6 rows -> 1 (6 x 6 sites); fc 4
# columns -> 1.  mini pool 8 rows -> 1 (8 x 2 sites); conv 12 slab rows ->
# 2 (of 12 x 4), 8 frame rows -> 1 (of 8 x 4); pool 1 row; fc 8 and 3
# columns -> 1
SHARES = {"tiny": [(2 * 16 * 6, 2, 2 * 12 * 6), (36, 2, 36), (1, 1, 1)],
          "mini": [(16, 1, 16), (2 * 12 * 4, 2, 8 * 4), (16, 1, 16),
                   (1, 1, 1), (1, 1, 1)]}


@pytest.mark.parametrize("net", ["tiny", "mini"])
def test_smem_layout_is_per_cta(net):
    prog = network_case(net, "f32", None, 0)[0]
    layers = lp._net_layers(prog)
    slabs = tuple(lp._slab_shape(op) for op in prog.ops)
    assert [nw.ops.share_shape(nl, sl) for nl, sl in zip(layers, slabs)] \
        == SHARES[net]
    lay = nw.smem_layout(layers, slabs, 4)
    # regions in order, 16-byte aligned, none overlapping the next
    offs = [*lay.mem_off, *lay.mask_off,
            *(o for o in lay.w_off if o >= 0), lay.hot_off, lay.bits_off,
            lay.list_off, lay.kept_off, lay.tally_off, lay.fcbuf_off]
    assert offs == sorted(offs) and all(o % 16 == 0 for o in offs)
    for (mem, words, _), m0, k0 in zip(SHARES[net], lay.mem_off,
                                       lay.mask_off):
        assert m0 + 4 * mem <= lay.mask_off[0] and k0 + 4 * words <= \
            min(o for o in lay.w_off if o >= 0)
    # a routed list holds the widest share of a frame, or the next cap'
    caps = [nl.cap for nl in layers[1:]]
    assert lay.list_cap == max(min(f, c) for (_, _, f), c in
                               zip(SHARES[net], caps))
    # two segment counts a CTA-owned frame row, then the two lists
    assert lay.seg_cap == {"tiny": 2, "mini": 1}[net]
    assert lay.nseg_cap == (12 if net == "tiny" else 8)
    assert lay.kept_off - lay.list_off >= 4 * (4 + 2 * lay.list_cap)
    assert lay.tally_off - lay.kept_off == 16 * nw.ops.PER_LANE * \
        nw.ops.THREADS
    # last, the fc walk's staging buffer: every net here has an fc layer
    assert lay.total == lay.fcbuf_off + 4 * nw.ops.FC_BUF
    assert lay.total == lp.network_window_plan(prog).smem_bytes


@pytest.mark.parametrize("dtype_policy", POLICIES)
def test_fig6_plan_fits_the_h100_budget(dtype_policy):
    spec = dvs_gesture_net()
    if dtype_policy == "int8-native":
        spec = quantize_net(init_snn(np.random.default_rng(0), spec,
                                     device="cpu"), spec).spec
    prog = lp.compile_program(spec, device="cpu", policy=ExecutionPolicy(
        dtype_policy=dtype_policy, fusion_policy="fused-network"))
    plan = lp.network_window_plan(prog)
    assert plan.smem_bytes == (plan.membrane_bytes + plan.weight_bytes
                               + plan.tile_bytes + plan.frame_bytes
                               + plan.stage_bytes)
    # one CTA of a cluster of 8 per slot, priced at its widest share:
    # pool0 4 rows (256 sites), conv1 5 slab rows of 40 x 16, pool1 2 rows
    # (512), conv2 3 slab rows of 20 x 32, pool2 1 row (256), fc1 64
    # columns, fc2 2 (padded to 16 bytes); one hot bit a site, in words
    # (conv: 2 words a row of 40, 1 of 20; each layer's 16-byte aligned)
    assert plan.ctas == nw.CLUSTER == 8
    sites = 256 + 5 * 40 * 16 + 512 + 3 * 20 * 32 + 256 + 64 + 4
    words = 8 + 12 + 16 + 4 + 8 + 4 + 4
    assert plan.membrane_bytes == 4 * (sites + words)
    # conv and pool weights, 5458 of them in every CTA, 16-byte aligned
    w_isz = 4 if dtype_policy == "f32-carrier" else 1
    assert 5458 * w_isz <= plan.weight_bytes < 5458 * w_isz + 5 * 16
    # conv1's share of the frame in bits (4 of its 32 rows of 32x16 a
    # CTA), then a count for each of a CTA's 4 rows of a frame, twice, and
    # two routed lists of as many int32 sites
    assert plan.frame_bytes == 2048 // 8 + 4 * (8 + 2 * 2048)
    assert plan.smem_bytes <= nw.SMEM_BUDGET == 232_448
    assert lp.effective_fusion(prog) == "fused-network"
