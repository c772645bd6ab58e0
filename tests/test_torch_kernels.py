"""The port's scatter kernels and its fused LIF kernel against the JAX
reference, and all eight CUDA kernels against their plain versions on the
card.

The same numpy inputs go through the port's wrapper on CPU tensors (which
runs the plain PyTorch version) and through the JAX package's
``*_batched_ref`` oracle, under every dtype pairing of
``layer_program.scatter_dtypes``, with unquantized float weights (so the
accumulation order is visible), zero gates, pool VALID drops and empty
batches.  One interpret-mode Pallas check per kernel runs at the smallest
shape.  Every comparison is exact (``np.array_equal``, which counts -0.0
equal to +0.0: a gated-off event in the reference adds ``w * 0``, which
can flip the sign of a zero and nothing else; the port skips it).  The
window kernels' plain versions are held against the reference in
``test_torch_window.py``, on the inputs :func:`window_case` builds here,
and the fused-network plain version in ``test_torch_network.py``, on the
inputs :func:`network_case` builds here.

The CUDA kernels themselves run only on a card: their tests carry the
``gpu`` marker and skip here.  The card's machine has no JAX, so this file
imports the reference lazily; there the card tests run with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_kernels.py
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import layer_program as lp
from repro_torch.core.econv import EConvSpec
from repro_torch.core.lif import LifParams
from repro_torch.core.policies import ExecutionPolicy
from repro_torch.core.quant import quantize_net
from repro_torch.core.sne_net import SNNSpec, init_snn, tiny_net
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.event_conv import (event_conv_batched,
                                            event_conv_window,
                                            event_conv_window_ref)
from repro_torch.kernels.event_conv.ops import (BLOCK_SMEM, TARGET_BLOCKS,
                                                conv_plan, conv_smem)
from repro_torch.kernels.event_conv.ref import event_conv_batched_ref
from repro_torch.kernels.event_fc import (event_fc_batched, event_fc_window,
                                          event_fc_window_ref)
from repro_torch.kernels.event_fc.ops import FC_THREADS, fc_column_block
from repro_torch.kernels.event_fc.ref import event_fc_batched_ref
from repro_torch.kernels.event_pool import (event_pool_batched,
                                            event_pool_window,
                                            event_pool_window_ref)
from repro_torch.kernels.event_pool.ops import (MAX_OWNED_PER_THREAD,
                                                pool_blocks_per_slot)
from repro_torch.kernels.event_pool.ref import event_pool_batched_ref
from repro_torch.kernels.lif import lif_fused, lif_fused_ref
from repro_torch.kernels.network_window import (CLUSTER, network_window,
                                                network_window_ref)
from repro_torch.kernels.window_common import (dilate_conv, dilate_pool,
                                               seed_site_map, sites_to_tiles,
                                               tile_grid)

torch.set_num_threads(1)

# (slab dtype, weight dtype, gate dtype, accumulator) per pairing
PAIRINGS = {
    "f32": (np.float32, np.float32, np.float32, np.float32),
    "int8": (np.int8, np.int8, np.int8, np.int32),
    "int32": (np.int32, np.int8, np.int32, np.int32),
}

# events a pool block stages per pass (csrc/pool_walk.cuh kStage)
POOL_STAGE = 2048
# below one stage, one stage, stages and a remainder, Fig. 6 pool1's list
POOL_WALK_E = [100, POOL_STAGE, 2 * POOL_STAGE + 333, 16384]
GATE_PATTERNS = ["prefix", "holes", "empty_slot", "ragged", "repeats",
                 "outside"]
# input (H, W, C) at stride 2: 16x16x16 pooled sites, so 8 blocks share a
# slot and each thread owns two; row 32 of the input is past the grid
POOL_WALK_GEOMETRY = (33, 32, 16)


def _arrays(rng, slab, wshape, pairing):
    v_dt, w_dt, _, _ = PAIRINGS[pairing]
    if pairing == "f32":
        v = rng.standard_normal(slab).astype(np.float32)
        w = rng.standard_normal(wshape).astype(np.float32)
    else:
        lo = -127 if v_dt == np.int8 else -1000
        v = rng.integers(lo, -lo + 1, slab).astype(v_dt)
        w = rng.integers(-8, 8, wshape).astype(w_dt)
    return v, w


def _events(rng, N, E, hi, pairing, p_on=0.8):
    xyc = np.stack([rng.integers(0, h, (N, E)) for h in hi],
                   -1).astype(np.int32)
    gate = (rng.random((N, E)) < p_on).astype(PAIRINGS[pairing][2])
    return xyc, gate


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _ref(kind, name):
    """A function of the JAX package's ``kernels/event_<kind>/<module>``."""
    module, fn = name.split(".")
    return getattr(importlib.import_module(
        f"repro.kernels.event_{kind}.{module}"), fn)


def _jax(kind, v, w, xyc, gate, *args, out):
    """The JAX reference oracle ``event_<kind>_batched_ref`` on numpy."""
    import jax.numpy as jnp
    fn = _ref(kind, f"ref.event_{kind}_batched_ref")
    return np.asarray(fn(jnp.asarray(v), jnp.asarray(w), jnp.asarray(xyc),
                         jnp.asarray(gate), *args, out_dtype=out))


def _torch_out(pairing):
    return torch.from_numpy(np.zeros((), PAIRINGS[pairing][3])).dtype


# ---------------------------------------------------------------------------
# conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pairing", list(PAIRINGS))
@pytest.mark.parametrize("N,H,W,Co,K,Ci,E", [
    (3, 6, 6, 4, 3, 2, 24),
    (2, 8, 8, 6, 5, 3, 40),
    (1, 5, 7, 3, 1, 2, 12),
])
def test_conv_plain_matches_jax(pairing, N, H, W, Co, K, Ci, E):
    rng = np.random.default_rng(N * 100 + K * 10 + Co)
    Hp, Wp = H + K - 1, W + K - 1
    v, w = _arrays(rng, (N, Hp, Wp, Co), (K, K, Ci, Co), pairing)
    xyc, gate = _events(rng, N, E, (H, W, Ci), pairing)
    acc = PAIRINGS[pairing][3]
    got = event_conv_batched(_t(v), _t(w), _t(xyc), _t(gate),
                             out_dtype=_torch_out(pairing)).numpy()
    want = _jax("conv", v, w, xyc, gate, out=acc)
    assert got.dtype == want.dtype == acc
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("N,geometry,want", [
    (8, (40, 40, 16, 5, 2), (3, 16)),      # Fig. 6 conv1: 14 bands a slot
    (8, (20, 20, 32, 3, 16), (2, 32)),     # Fig. 6 conv2: 10 bands a slot
    (2, (264, 350, 8, 5, 2), (4, 8)),      # a DAVIS346 sensor (260x346)
    (1, (264, 350, 1, 5, 2), (2, 1)),      # the same at one channel
    (8, (724, 1284, 16, 5, 2), (2, 16)),   # a 720x1280 sensor
])
def test_conv_step_plan(N, geometry, want):
    # the per-step kernel bands its slab as the window kernel does: a
    # block holds a few rows, never the whole slab, so a slab far past
    # what one block's shared memory holds is served (the old rule, one
    # block a slot, refused any slab over about 51k sites)
    Hp, Wp, Co, K, Ci = geometry
    rows, co_blk = conv_plan(N, Hp, Wp, Co, K, Ci, window=False)
    assert (rows, co_blk) == want
    assert Co % co_blk == 0
    assert conv_smem(rows, Wp, co_blk, K, Ci, window=False) <= BLOCK_SMEM
    # one row at one channel is far inside a block's shared memory
    assert conv_smem(1, Wp, 1, K, Ci, window=False) <= BLOCK_SMEM // 4
    blocks = N * -(-Hp // rows) * (Co // co_blk)
    assert blocks <= max(TARGET_BLOCKS, N * Co // co_blk) or \
        conv_smem(rows + 1, Wp, co_blk, K, Ci, window=False) > BLOCK_SMEM
    # the per-step block keeps no hot bits or bitmap
    assert conv_smem(rows, Wp, co_blk, K, Ci, window=False) < \
        conv_smem(rows, Wp, co_blk, K, Ci, window=True)


# ---------------------------------------------------------------------------
# pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pairing", list(PAIRINGS))
@pytest.mark.parametrize("N,H,W,C,s,E", [
    (3, 8, 8, 3, 2, 32),
    (2, 16, 16, 2, 4, 64),
    (2, 7, 9, 2, 2, 40),        # H % s, W % s != 0: VALID drops
])
def test_pool_plain_matches_jax(pairing, N, H, W, C, s, E):
    rng = np.random.default_rng(N * 100 + s * 10 + C)
    v, w = _arrays(rng, (N, H // s, W // s, C), (C,), pairing)
    xyc, gate = _events(rng, N, E, (H, W, C), pairing)
    acc = PAIRINGS[pairing][3]
    got = event_pool_batched(_t(v), _t(w), _t(xyc), _t(gate), s,
                             out_dtype=_torch_out(pairing)).numpy()
    want = _jax("pool", v, w, xyc, gate, s, out=acc)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_sites,blocks", [
    (100, 1), (256, 1), (257, 2), (2048, 8), (4096, 8), (131072, 8),
    (131073, 16), (320 * 240 * 2, 16), (640 * 480 * 2, 64)])
def test_pool_blocks_per_slot(n_sites, blocks):
    # about one site a thread, at most 8 blocks unless a thread would own
    # more than MAX_OWNED_PER_THREAD sites (its shared-memory column)
    assert pool_blocks_per_slot(n_sites) == blocks
    assert -(-n_sites // (blocks * 256)) <= MAX_OWNED_PER_THREAD


def test_pool_valid_rule_drops_past_the_grid():
    v = np.zeros((1, 3, 3, 1), np.float32)       # 7 // 2 = 3 output rows
    w = np.ones((1,), np.float32)
    xyc = np.asarray([[[6, 6, 0], [0, 0, 0], [6, 1, 0]]], np.int32)
    gate = np.ones((1, 3), np.float32)
    got = event_pool_batched(_t(v), _t(w), _t(xyc), _t(gate), 2).numpy()
    np.testing.assert_array_equal(got, _jax("pool", v, w, xyc, gate, 2,
                                            out=np.float32))
    assert got[0, 0, 0, 0] == 1.0 and got.sum() == 1.0


@pytest.mark.parametrize("pattern", GATE_PATTERNS)
@pytest.mark.parametrize("pairing", list(PAIRINGS))
def test_pool_plain_matches_jax_gate_patterns(pairing, pattern):
    # the gate patterns the CUDA pool walk is held to on the card
    v, w, xyc, gate, s = pool_walk_case("batched", pairing, pattern, 48, 21,
                                        negative=False)
    acc = PAIRINGS[pairing][3]
    got = event_pool_batched(_t(v), _t(w), _t(xyc), _t(gate), s,
                             out_dtype=_torch_out(pairing)).numpy()
    np.testing.assert_array_equal(got, _jax("pool", v, w, xyc, gate, s,
                                            out=acc))


# ---------------------------------------------------------------------------
# fc
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pairing", list(PAIRINGS))
@pytest.mark.parametrize("N,H,W,C,D,E", [
    (3, 4, 4, 2, 6, 24),
    (2, 3, 3, 6, 11, 32),       # odd Dout (the class head)
    (2, 2, 2, 32, 512, 12),     # the Fig. 6 FC-512 width, reduced input
])
def test_fc_plain_matches_jax(pairing, N, H, W, C, D, E):
    rng = np.random.default_rng(N * 100 + D + E)
    v, w = _arrays(rng, (N, 1, 1, D), (H * W * C, D), pairing)
    xyc, gate = _events(rng, N, E, (H, W, C), pairing)
    acc = PAIRINGS[pairing][3]
    got = event_fc_batched(_t(v), _t(w), _t(xyc), _t(gate), (H, W, C),
                           out_dtype=_torch_out(pairing)).numpy()
    want = _jax("fc", v, w, xyc, gate, (H, W, C), out=acc)
    np.testing.assert_array_equal(got, want)


def fc_walk_case(pairing, pattern, N, E, Dout, seed, negative):
    """Numpy inputs ``(v, w, xyc, gate, in_shape)`` of one per-step fc
    launch for a gate pattern: an 8x8x4 input (Din 256) onto ``Dout``
    columns (``pairing`` one of ``PAIRINGS``), events from
    :func:`_gate_pattern` (rows out of range for "outside", negative
    coordinates too if ``negative``)."""
    rng = np.random.default_rng(seed)
    in_shape = (8, 8, 4)
    v, w = _arrays(rng, (N, 1, 1, Dout), (int(np.prod(in_shape)), Dout),
                   pairing)
    xyc, gate = _gate_pattern(rng, pattern, N, E, in_shape, np.arange(N),
                              PAIRINGS[pairing][2], negative)
    return v, w, xyc, gate, in_shape


@pytest.mark.parametrize("pattern", [p for p in GATE_PATTERNS
                                     if p != "outside"])
@pytest.mark.parametrize("pairing", list(PAIRINGS))
def test_fc_plain_matches_jax_gate_patterns(pairing, pattern):
    # the gate patterns the CUDA per-step fc is held to on the card, inside
    # the reference's contract: rows out of range ("outside") are left out,
    # since the JAX oracle's `jnp.take` fills them, and float gates are 0/1
    # (the oracle's contract: on the CPU, XLA fuses its multiply and add
    # into one FMA, which rounds once where the port rounds twice, so a
    # gate other than 0 or 1 shows a last-bit difference); the integer
    # pairings keep the non-unit gates, which are exact there
    v, w, xyc, gate, in_shape = fc_walk_case(pairing, pattern, 4, 48, 11,
                                             51, negative=False)
    if pairing == "f32":
        gate = (gate != 0).astype(gate.dtype)
    acc = PAIRINGS[pairing][3]
    got = event_fc_batched(_t(v), _t(w), _t(xyc), _t(gate), in_shape,
                           out_dtype=_torch_out(pairing)).numpy()
    np.testing.assert_array_equal(got, _jax("fc", v, w, xyc, gate, in_shape,
                                            out=acc))


@pytest.mark.parametrize("N,Dout,cols,blocks", [
    (8, 512, 32, 128),          # Fig. 6 fc1: 16 column blocks a slot
    (8, 11, 11, 8),             # Fig. 6 fc2: one block a slot
    (8, 100, 32, 32),           # 32 does not divide 100: a 4-column block
    (1, 512, 32, 16),           # one slot: a row segment a block
    (8, 2048, 128, 128),
    (200, 512, 256, 400),       # more slots than SMs: a column a thread
])
def test_fc_column_block(N, Dout, cols, blocks):
    got = fc_column_block(N, Dout)
    assert got == cols and got <= FC_THREADS
    per_slot = -(-Dout // got)
    # every column in exactly one block, none empty
    assert (per_slot - 1) * got < Dout <= per_slot * got
    assert N * per_slot == blocks
    # whole row segments, unless the layer is narrower than one
    assert got % 32 == 0 or got == Dout


# ---------------------------------------------------------------------------
# edges shared by the three wrappers
# ---------------------------------------------------------------------------

def _case(kind, rng, N, E, pairing="f32"):
    """(wrapper, slab, weights, extra args, input hi) per kind."""
    if kind == "conv":
        v, w = _arrays(rng, (N, 8, 8, 4), (3, 3, 2, 4), pairing)
        return event_conv_batched, v, w, (), (6, 6, 2)
    if kind == "pool":
        v, w = _arrays(rng, (N, 4, 4, 3), (3,), pairing)
        return event_pool_batched, v, w, (2,), (8, 8, 3)
    v, w = _arrays(rng, (N, 1, 1, 5), (18, 5), pairing)
    return event_fc_batched, v, w, ((3, 3, 2),), (3, 3, 2)


@pytest.mark.parametrize("kind", ["conv", "pool", "fc"])
def test_zero_gates_leave_the_slab(kind):
    rng = np.random.default_rng(5)
    fn, v, w, extra, hi = _case(kind, rng, 2, 9)
    xyc, _ = _events(rng, 2, 9, hi, "f32")
    gate = np.zeros((2, 9), np.float32)
    got = fn(_t(v), _t(w), _t(xyc), _t(gate), *extra).numpy()
    np.testing.assert_array_equal(got, v)
    np.testing.assert_array_equal(got, _jax(kind, v, w, xyc, gate, *extra,
                                            out=np.float32))


@pytest.mark.parametrize("kind", ["conv", "pool", "fc"])
@pytest.mark.parametrize("N,E", [(0, 5), (2, 0)])
def test_empty_batch_is_identity_without_launch(kind, N, E):
    rng = np.random.default_rng(6)
    fn, v, w, extra, _ = _case(kind, rng, N, E, "int8")
    xyc = np.zeros((N, E, 3), np.int32)
    gate = np.zeros((N, E), np.int8)
    before = dict(LAUNCHES)
    got = fn(_t(v), _t(w), _t(xyc), _t(gate), *extra,
             out_dtype=torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), v.astype(np.int32))
    assert LAUNCHES == before


@pytest.mark.parametrize("kind", ["conv", "pool", "fc"])
def test_unsupported_dtype_pairing_raises(kind):
    rng = np.random.default_rng(7)
    fn, v, w, extra, hi = _case(kind, rng, 2, 4)
    xyc, gate = _events(rng, 2, 4, hi, "f32")
    with pytest.raises(TypeError, match="unsupported dtypes"):
        fn(_t(v), _t(w.astype(np.int8)), _t(xyc), _t(gate), *extra)


# ---------------------------------------------------------------------------
# one interpret-mode Pallas check per kernel (smallest shape)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["conv", "pool", "fc"])
def test_plain_matches_interpret_mode_pallas(kind):
    rng = np.random.default_rng(8)
    fn, v, w, extra, hi = _case(kind, rng, 2, 6)
    xyc, gate = _events(rng, 2, 6, hi, "f32")
    got = fn(_t(v), _t(w), _t(xyc), _t(gate), *extra).numpy()
    import jax.numpy as jnp
    pallas = _ref(kind, f"kernel.event_{kind}_batched_pallas")
    block = {"conv": dict(co_blk=4), "pool": dict(stride=2),
             "fc": dict(in_shape=(3, 3, 2), d_blk=5)}[kind]
    want = pallas(*map(jnp.asarray, (v, w, xyc, gate)), interpret=True,
                  **block)
    np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# the fused LIF boundary (off the serving path; the reference's shapes)
# ---------------------------------------------------------------------------

LIF_SHAPES = [(64,), (33, 7), (8, 16, 4), (1000,), (256, 128)]


def lif_case(shape, dt):
    rng = np.random.default_rng(dt + len(shape))
    v = rng.normal(size=shape).astype(np.float32) * 2
    syn = rng.normal(size=shape).astype(np.float32)
    return v, syn


@pytest.mark.parametrize("shape", LIF_SHAPES)
@pytest.mark.parametrize("dt", [0, 1, 5])
@pytest.mark.parametrize("clip", [None, 3.0])
def test_lif_fused_plain_matches_jax(shape, dt, clip):
    import jax.numpy as jnp
    jref = importlib.import_module("repro.kernels.lif.ref").lif_fused_ref
    v, syn = lif_case(shape, dt)
    got = lif_fused(_t(v), _t(syn), torch.tensor(float(dt)), 0.1, 0.9, clip)
    want = jref(jnp.asarray(v), jnp.asarray(syn), jnp.asarray(float(dt)),
                0.1, 0.9, clip)
    for g, w in zip(got, want):               # bitwise, not to 1e-6
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].any() and not got[1].all()


# ---------------------------------------------------------------------------
# the fused window kernels' inputs (used here and by test_torch_window.py)
# ---------------------------------------------------------------------------

# (slab, weights, gate, accumulator) of the window kernels' two pairings
WINDOW_PAIRINGS = {
    "f32": (np.float32, np.float32, np.float32, np.float32),
    "native": (np.int8, np.int8, np.int32, np.int32),
}
# hard-reset plans: a dyadic leak keeps the cold-tile decay exact in f32
WINDOW_LIF = {"f32": LifParams(threshold=1.5, leak=0.25, state_clip=8.0),
              "native": LifParams(threshold=14.0, leak=2.0,
                                  state_clip=127.0)}
# (input geometry, output channels) per kind; prime sides, pool remainders
WINDOW_GEOMETRY = {"conv": ((7, 9, 2), 4), "pool": ((10, 11, 3), 3),
                   "fc": ((2, 3, 2), 5)}


def window_case(kind, pairing, tiles, seed, N=3, T=4, E=12,
                pattern="random", geometry=None):
    """Numpy inputs of one window launch of ``kind`` and its keywords.

    ``tiles`` is None (dense), ``"ones"`` (an all-hot bitmap) or
    ``"sparse"``: events confined to the top-left third, the bitmap
    propagated from them as `window_tile_maps` does, and starting
    membranes below threshold (the serving invariant cold tiles rest on).
    Slot 1 freezes its last timestep and slot 2 its second.  ``pattern``
    "random" draws unsorted events with 0/1 gates; any of
    :data:`GATE_PATTERNS` takes events and gates from
    :func:`_gate_pattern` instead (conv: duplicates, non-unit gates, and
    coordinates the kernel must clamp).  ``geometry`` ((H, W, C), Co)
    replaces the kind's :data:`WINDOW_GEOMETRY`.

    Returns ``(v, w, xyc, gate, alive, kwargs)``; ``xyc`` is slot-major
    (N, T, E, 3), in halo coordinates for conv; ``kwargs`` holds
    ``lif``, the kind's geometry keyword, ``native`` and ``tiles`` (numpy
    or None; fc takes none).
    """
    rng = np.random.default_rng(seed)
    (H, W, C), Co = geometry or WINDOW_GEOMETRY[kind]
    v_dt, w_dt, g_dt, _ = WINDOW_PAIRINGS[pairing]
    lif = WINDOW_LIF[pairing]
    hi = (H, W) if tiles != "sparse" else (max(1, H // 3), max(1, W // 3))
    xyc = np.stack([rng.integers(0, hi[0], (N, T, E)),
                    rng.integers(0, hi[1], (N, T, E)),
                    rng.integers(0, C, (N, T, E))], -1).astype(np.int32)
    gate = (rng.random((N, T, E)) < 0.75).astype(g_dt)
    if pattern != "random":
        xyc, gate = _gate_pattern(np.random.default_rng(seed + 1000),
                                  pattern, N * T, E, (*hi, C),
                                  np.arange(N * T) // T, g_dt, True)
        xyc, gate = xyc.reshape(N, T, E, 3), gate.reshape(N, T, E)
    alive = np.ones((N, T), np.float32)
    alive[1, -1] = alive[2 % N, 1] = 0.0
    kw = {"lif": lif, "native": pairing == "native"}
    if kind == "conv":
        K, P = 3, 1
        Ho, Wo, h = H + 2 * P - K + 1, W + 2 * P - K + 1, K - 1
        slab, wshape = (N, Ho + 2 * h, Wo + 2 * h, Co), (K, K, C, Co)
        kw["halo"] = h
    elif kind == "pool":
        s = 2
        Ho, Wo = H // s, W // s
        slab, wshape = (N, Ho, Wo, C), (C,)
        kw["stride"] = s
    else:
        Ho = Wo = 1
        slab, wshape = (N, 1, 1, Co), (H * W * C, Co)
        kw["in_shape"] = (H, W, C)
    top = lif.threshold - (1 if pairing == "native" else 0.1)
    if pairing == "f32":
        v = rng.uniform(-1.4, top if tiles == "sparse" else 2.5, slab)
        w = rng.standard_normal(wshape)
    else:
        v = rng.integers(-127, int(top) + 1 if tiles == "sparse" else 128,
                         slab)
        w = rng.integers(-8, 8, wshape)
    v, w = v.astype(v_dt), w.astype(w_dt)
    bitmap = None
    if tiles is not None and kind != "fc":
        grid = tile_grid(Ho, Wo)
        if tiles == "ones":
            bitmap = np.ones((N, grid[0], grid[1]), np.int32)
        else:
            sites = seed_site_map(_t(xyc.transpose(1, 0, 2, 3)),
                                  _t(gate.transpose(1, 0, 2)), (H, W))
            sites = (dilate_conv(sites, K, P) if kind == "conv"
                     else dilate_pool(sites, s, (Ho, Wo)))
            bitmap = sites_to_tiles(sites, grid).numpy()
            assert 0 < bitmap.sum() < bitmap.size, "tiles should be mixed"
    if kind == "conv":
        xyc = xyc + np.asarray([P, P, 0], np.int32)
    if kind != "fc":
        kw["tiles"] = bitmap
    return v, w, xyc, gate, alive, kw


WINDOW_FNS = {"conv": (event_conv_window, event_conv_window_ref),
              "pool": (event_pool_window, event_pool_window_ref),
              "fc": (event_fc_window, event_fc_window_ref)}


# ---------------------------------------------------------------------------
# the pool kernels' event walk: list lengths and gate patterns
# ---------------------------------------------------------------------------

def _gate_pattern(rng, pattern, rows, E, hi, slot, g_dt, negative):
    """Events ``(rows, E, 3)`` and gates ``(rows, E)`` of one pattern.

    ``prefix``: a gated prefix of random length, as `route_frame` pads;
    ``holes``: scattered gates and a long gated-off run inside the list;
    ``empty_slot``: a prefix, with slot 1 (``slot`` maps rows to slots)
    gated off everywhere; ``ragged``: each row's walk ends somewhere else,
    stage edges among them, with holes before the end; ``repeats``: a few
    sites hit over and over with non-unit gates (the order of the adds
    shows); ``outside``: past-the-grid coordinates, and negative ones if
    ``negative``.
    """
    H, W, C = hi
    idx = np.arange(E)
    if pattern == "repeats":
        # (0, 0, 1) and (1, 1, 1) pool to one site at stride 2
        sites = np.asarray([[0, 0, 1], [1, 1, 1], [2, 3, 0], [5, 2, 1]],
                           np.int32)
        xyc = sites[rng.integers(0, len(sites), (rows, E))]
    else:
        lo = (-3, -3, -1) if pattern == "outside" and negative else (0,) * 3
        top = (H + 3, W + 3, C + 1) if pattern == "outside" else (H, W, C)
        xyc = np.stack([rng.integers(a, b, (rows, E))
                        for a, b in zip(lo, top)], -1).astype(np.int32)
    if pattern in ("prefix", "empty_slot", "repeats"):
        on = idx < rng.integers(1, E + 1, (rows, 1))
    elif pattern == "holes":
        on = rng.random((rows, E)) < 0.3
        on[:, E // 3: 2 * E // 3] = False
    elif pattern == "ragged":
        ends = np.unique(np.clip([E, 1, E - 1, POOL_STAGE + 1,
                                  POOL_STAGE - 1, POOL_STAGE, E // 2, 33],
                                 1, E))[::-1]
        end = ends[np.arange(rows) % len(ends)]
        on = (idx < end[:, None]) & (rng.random((rows, E)) < 0.7)
        on[np.arange(rows), end - 1] = True
    else:
        on = rng.random((rows, E)) < 0.8
    if pattern == "empty_slot":
        on[slot == 1] = False
    if pattern in ("repeats", "holes"):
        if np.issubdtype(g_dt, np.floating):
            val = rng.standard_normal((rows, E))
        else:
            val = rng.choice([-3, -2, 2, 3], (rows, E))
    else:
        val = np.ones((rows, E))
    return xyc, np.where(on, val, 0).astype(g_dt)


def pool_walk_case(kind, pairing, pattern, E, seed, tiles="ones", N=4,
                   T=3, negative=True):
    """Numpy inputs of one pool launch for a gate pattern.

    ``kind`` "batched" returns ``(v, w, xyc, gate, stride)`` for
    ``event_pool_batched`` (``pairing`` one of ``PAIRINGS``); "window"
    returns ``(v, w, xyc, gate, alive, kwargs)`` for ``event_pool_window``
    (``pairing`` one of ``WINDOW_PAIRINGS``), with slot 1 frozen at its
    last timestep and slot 2 at its second, and ``tiles`` "ones" (an
    all-hot bitmap) or "sparse" (events in the top-left third, the bitmap
    `window_tile_maps` would propagate from them, starting membranes
    below threshold).  Weights are unquantised in f32.

    ``negative`` False keeps coordinates non-negative: the reference's
    contract has none (its oracle wraps a negative index, its Pallas
    kernel clamps the row and drops the channel), while the port drops
    the event; the JAX parity cases pass False.
    """
    rng = np.random.default_rng(seed)
    H, W, C = POOL_WALK_GEOMETRY
    s = 2
    slab = (N, H // s, W // s, C)
    if kind == "batched":
        v, w = _arrays(rng, slab, (C,), pairing)
        xyc, gate = _gate_pattern(rng, pattern, N, E, (H, W, C),
                                  np.arange(N), PAIRINGS[pairing][2],
                                  negative)
        return v, w, xyc, gate, s
    v_dt, w_dt, g_dt, _ = WINDOW_PAIRINGS[pairing]
    lif = WINDOW_LIF[pairing]
    hi = (H // 3, W // 3, C) if tiles == "sparse" else (H, W, C)
    xyc, gate = _gate_pattern(rng, pattern, N * T, E, hi,
                              np.arange(N * T) // T, g_dt, negative)
    xyc, gate = xyc.reshape(N, T, E, 3), gate.reshape(N, T, E)
    alive = np.ones((N, T), np.float32)
    alive[1, -1] = alive[2, 1] = 0.0
    top = lif.threshold - (1 if pairing == "native" else 0.1)
    if pairing == "f32":
        v = rng.uniform(-1.4, top if tiles == "sparse" else 2.5, slab)
        w = rng.standard_normal((C,))
    else:
        v = rng.integers(-127, int(top) + 1 if tiles == "sparse" else 128,
                         slab)
        w = rng.integers(-8, 8, (C,))
    grid = tile_grid(*slab[1:3])
    if tiles == "sparse":
        sites = seed_site_map(_t(xyc.transpose(1, 0, 2, 3)),
                              _t(gate.transpose(1, 0, 2)), (H, W))
        bitmap = sites_to_tiles(dilate_pool(sites, s, slab[1:3]),
                                grid).numpy()
        assert bitmap.sum() < bitmap.size, "tiles should be mixed"
    else:
        bitmap = np.ones((N, grid[0], grid[1]), np.int32)
    kw = {"lif": lif, "native": pairing == "native", "stride": s,
          "tiles": bitmap}
    return v.astype(v_dt), w.astype(w_dt), xyc, gate, alive, kw


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("pairing", list(PAIRINGS))
@pytest.mark.parametrize("kind", ["conv", "pool", "fc"])
def test_cuda_kernel_matches_plain(cuda, kind, pairing):
    rng = np.random.default_rng(9)
    N, E = 4, 200
    fn, v, w, extra, hi = _case(kind, rng, N, E, pairing)
    xyc, gate = _events(rng, N, E, hi, pairing)
    plain = {"conv": event_conv_batched_ref, "pool": event_pool_batched_ref,
             "fc": event_fc_batched_ref}[kind]
    out = _torch_out(pairing)
    args = [_t(a).to(cuda) for a in (v, w, xyc, gate)]
    before = LAUNCHES[f"event_{kind}_batched"]
    got = fn(*args, *extra, out_dtype=out)
    want = plain(*args, *extra, out_dtype=out)
    torch.cuda.synchronize()
    assert LAUNCHES[f"event_{kind}_batched"] == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("pairing", list(WINDOW_PAIRINGS))
@pytest.mark.parametrize("kind,tiles,pattern,N,E", [
    ("conv", None, "random", 4, 200), ("conv", "sparse", "random", 4, 200),
    ("pool", None, "random", 4, 200), ("pool", "sparse", "random", 4, 200),
    ("fc", None, "random", 4, 200), ("conv", "ones", "ragged", 4, 2500)] + [
    ("conv", t, p, n, 200) for t in ("ones", "sparse") for p in GATE_PATTERNS
    for n in (4, 24) if not (t == "sparse" and p == "outside")])
def test_cuda_window_kernel_matches_plain(cuda, kind, tiles, pattern, N, E,
                                          pairing):
    # E = 200 events a timestep; E = 2500: more than one 1024-event stage
    # of the conv walk.  At 4 slots each conv band is one slab row; at 24
    # slots the 11-row slab is dealt to 4 bands of at most 3 rows (rows 0,
    # 4, 8; 1, 5, 9; 2, 6, 10; 3, 7), so every patch spans several bands
    # and one band is short; the 13-column slab leaves the second run of
    # each row half empty.
    # Unsorted events, duplicates, non-unit gates, holes, an empty slot and
    # clamped coordinates (GATE_PATTERNS) hold the conv walk's order.
    v, w, xyc, gate, alive, kw = window_case(kind, pairing, tiles, 10, N=N,
                                             T=4, E=E, pattern=pattern)
    if kind == "conv":
        band_rows, co_blk = conv_plan(N, v.shape[1], v.shape[2],
                                      v.shape[3], w.shape[0], w.shape[2],
                                      window=True)
        assert (band_rows, co_blk) == ((1, 4) if N == 4 else (3, 4))
    if kw.get("tiles") is not None:
        kw["tiles"] = _t(kw["tiles"]).to(cuda)
    fn, plain = WINDOW_FNS[kind]
    args = [_t(a).to(cuda) for a in (v, w, xyc, gate, alive)]
    before = LAUNCHES[f"event_{kind}_window"]
    got = fn(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES[f"event_{kind}_window"] == before + 1
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and torch.equal(g, x)


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", GATE_PATTERNS)
@pytest.mark.parametrize("E", POOL_WALK_E)
@pytest.mark.parametrize("kind,pairing,tiles", [
    ("batched", p, None) for p in PAIRINGS] + [
    ("window", p, t) for p in WINDOW_PAIRINGS for t in ("ones", "sparse")])
def test_cuda_pool_walk_matches_plain(cuda, kind, pairing, tiles, E,
                                      pattern):
    # the pool kernels walk only up to each row's last gated event and
    # only the events their block owns; the plain version (the wrapper on
    # CPU copies) walks the list as the reference does
    case = pool_walk_case(kind, pairing, pattern, E, 31, tiles=tiles)
    if kind == "batched":
        v, w, xyc, gate, s = case
        fn, kw = event_pool_batched, {"stride": s,
                                      "out_dtype": _torch_out(pairing)}
        arrays = (v, w, xyc, gate)
    else:
        v, w, xyc, gate, alive, kw = case
        fn = event_pool_window
        arrays = (v, w, xyc, gate, alive)
    args = [_t(a) for a in arrays]
    kw_cpu = {k: (_t(x) if k == "tiles" else x) for k, x in kw.items()}
    kw_dev = {k: (x.to(cuda) if k == "tiles" else x)
              for k, x in kw_cpu.items()}
    name = f"event_pool_{kind}"
    before = LAUNCHES[name]
    got = fn(*[a.to(cuda) for a in args], **kw_dev)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    want = fn(*args, **kw_cpu)
    for g, x in zip(_as_tuple(got), _as_tuple(want)):
        assert g.dtype == x.dtype and torch.equal(g.cpu(), x)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["batched", "window"])
def test_cuda_pool_large_slab_matches_plain(cuda, kind):
    # a 640x480 sensor pooled by 2: 153600 sites a slot, past 8 blocks of
    # 64 owned sites a thread, so 16 blocks share the slot
    rng = np.random.default_rng(33)
    N, T, E, Ho, Wo, C = 2, 2, 3000, 240, 320, 2
    assert pool_blocks_per_slot(Ho * Wo * C) == 16
    xyc = np.stack([rng.integers(0, 2 * Ho, (N, T, E)),
                    rng.integers(0, 2 * Wo, (N, T, E)),
                    rng.integers(0, C, (N, T, E))], -1).astype(np.int32)
    gate = rng.standard_normal((N, T, E)).astype(np.float32)
    gate[rng.random((N, T, E)) < 0.3] = 0
    v = rng.standard_normal((N, Ho, Wo, C)).astype(np.float32)
    w = rng.standard_normal((C,)).astype(np.float32)
    if kind == "batched":
        fn, arrays, kw = event_pool_batched, (v, w, xyc[:, 0], gate[:, 0]), \
            {"stride": 2}
    else:
        fn, arrays = event_pool_window, (v, w, xyc, gate,
                                         np.ones((N, T), np.float32))
        kw = {"lif": WINDOW_LIF["f32"], "stride": 2}
    args = [_t(a) for a in arrays]
    got = fn(*[a.to(cuda) for a in args], **kw)
    want = fn(*args, **kw)
    torch.cuda.synchronize()
    for g, x in zip(_as_tuple(got), _as_tuple(want)):
        assert g.dtype == x.dtype and torch.equal(g.cpu(), x)


def conv_walk_case(pairing, pattern, N, E, seed):
    """Numpy inputs ``(v, w, xyc, gate)`` of one per-step conv launch for a
    gate pattern: the conv window's geometry (an 11x13 halo-padded slab of
    4 channels, K = 3, 2 input channels; ``pairing`` one of ``PAIRINGS``),
    events from :func:`_gate_pattern` in halo coordinates, negative and
    past-the-slab ones included (the kernel clamps them)."""
    rng = np.random.default_rng(seed)
    (H, W, C), Co = WINDOW_GEOMETRY["conv"]
    K, P = 3, 1
    h = K - 1
    slab = (N, H + 2 * P - K + 1 + 2 * h, W + 2 * P - K + 1 + 2 * h, Co)
    v, w = _arrays(rng, slab, (K, K, C, Co), pairing)
    xyc, gate = _gate_pattern(rng, pattern, N, E, (H, W, C), np.arange(N),
                              PAIRINGS[pairing][2], True)
    return v, w, xyc + np.asarray([P, P, 0], np.int32), gate


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", GATE_PATTERNS)
@pytest.mark.parametrize("N,E", [(4, 201), (24, 201), (4, 2501)])
@pytest.mark.parametrize("pairing", list(PAIRINGS))
def test_cuda_conv_walk_matches_plain(cuda, pairing, N, E, pattern):
    # the per-step conv on the window kernel's walk: at 4 slots each band
    # is one slab row, at 24 the 11-row slab is dealt to 4 bands of at
    # most 3 rows, so a patch spans several bands; E = 2501 is past one
    # 1024-event stage; an odd E leaves most gate rows off a 16-byte
    # boundary.  Unsorted events, duplicates, non-unit gates, holes, an
    # empty slot and clamped coordinates hold each site's order.
    v, w, xyc, gate = conv_walk_case(pairing, pattern, N, E, 41)
    assert conv_plan(N, *v.shape[1:], w.shape[0], w.shape[2],
                     window=False) == ((1, 4) if N == 4 else (3, 4))
    out = _torch_out(pairing)
    args = [_t(a).to(cuda) for a in (v, w, xyc, gate)]
    before = LAUNCHES["event_conv_batched"]
    got = event_conv_batched(*args, out_dtype=out)
    want = event_conv_batched_ref(*args, out_dtype=out)
    torch.cuda.synchronize()
    assert LAUNCHES["event_conv_batched"] == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_conv_large_slab_matches_plain(cuda):
    # a DAVIS346 sensor (260x346) at K = 5: a 264x350 slab, 92400 sites a
    # channel, which the per-step kernel refused while one block held a
    # slot's whole slab
    rng = np.random.default_rng(34)
    N, E, Hp, Wp, Co, K, Ci = 2, 3000, 264, 350, 8, 5, 2
    xyc = np.stack([rng.integers(0, Hp - K + 1, (N, E)),
                    rng.integers(0, Wp - K + 1, (N, E)),
                    rng.integers(0, Ci, (N, E))], -1).astype(np.int32)
    gate = rng.standard_normal((N, E)).astype(np.float32)
    gate[rng.random((N, E)) < 0.3] = 0
    v = rng.standard_normal((N, Hp, Wp, Co)).astype(np.float32)
    w = rng.standard_normal((K, K, Ci, Co)).astype(np.float32)
    assert conv_plan(N, Hp, Wp, Co, K, Ci, window=False) == (4, 8)
    args = [_t(a).to(cuda) for a in (v, w, xyc, gate)]
    got = event_conv_batched(*args)
    want = event_conv_batched_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", GATE_PATTERNS)
@pytest.mark.parametrize("Dout,E", [(11, 201), (512, 201), (100, 201),
                                    (512, 2501)])
@pytest.mark.parametrize("pairing", list(WINDOW_PAIRINGS))
def test_cuda_fc_walk_matches_plain(cuda, pairing, Dout, E, pattern):
    # the fc window's staged column walk at 8 slots: Fig. 6 fc2's 11
    # columns (one block a slot; int8 rows off 4-byte boundaries), fc1's
    # 512 (16 blocks of 32) and 100 (the last block 4 columns wide);
    # E = 2501 is past one 1024-event stage and a chunk of staged rows,
    # an odd E leaves gate rows off a 16-byte boundary.  Duplicate rows,
    # non-unit gates, holes, an empty slot, rows out of range and frozen
    # timesteps hold each column's order.
    v, w, xyc, gate, alive, kw = window_case(
        "fc", pairing, None, 11, N=8, T=4, E=E, pattern=pattern,
        geometry=((8, 8, 4), Dout))
    args = [_t(a).to(cuda) for a in (v, w, xyc, gate, alive)]
    before = LAUNCHES["event_fc_window"]
    got = event_fc_window(*args, **kw)
    want = event_fc_window_ref(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["event_fc_window"] == before + 1
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and torch.equal(g, x)


@pytest.mark.gpu
@pytest.mark.parametrize("pattern", GATE_PATTERNS)
@pytest.mark.parametrize("Dout,E", [(11, 201), (512, 201), (100, 201),
                                    (512, 2501)])
@pytest.mark.parametrize("pairing", list(PAIRINGS))
def test_cuda_fc_batched_walk_matches_plain(cuda, pairing, Dout, E, pattern):
    # the per-step fc on the staged column walk at 8 slots, in all three
    # pairings: Fig. 6 fc2's 11 columns (one block a slot; int8 rows off
    # 4-byte boundaries), fc1's 512 (16 blocks of 32) and 100 (the last
    # block 4 columns wide); E = 2501 is past one 1024-event stage and a
    # chunk of staged rows; an odd E leaves gate rows (int8 ones above
    # all) off a 16-byte boundary.  Duplicate rows, non-unit gates, holes,
    # an empty slot and rows out of range hold each column's order.
    v, w, xyc, gate, in_shape = fc_walk_case(pairing, pattern, 8, E, Dout,
                                             52, negative=True)
    out = _torch_out(pairing)
    args = [_t(a).to(cuda) for a in (v, w, xyc, gate)]
    before = LAUNCHES["event_fc_batched"]
    got = event_fc_batched(*args, in_shape, out_dtype=out)
    want = event_fc_batched_ref(*args, in_shape, out_dtype=out)
    torch.cuda.synchronize()
    assert LAUNCHES["event_fc_batched"] == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the fused-network kernel's inputs (used here and by test_torch_network.py)
# ---------------------------------------------------------------------------

def mini_fig6(n_timesteps: int = 8) -> SNNSpec:
    """The Fig. 6 topology cut to 16x16x2: pool, conv, pool, fc, fc (every
    kind fed by the in-kernel routing, a conv among them)."""
    lif = LifParams(threshold=1.0, leak=0.03125)
    l0 = EConvSpec("pool", (16, 16, 2), 2, kernel=2, stride=2, lif=lif)
    l1 = EConvSpec("conv", l0.out_shape, 4, kernel=3, padding=1, lif=lif)
    l2 = EConvSpec("pool", l1.out_shape, 4, kernel=2, stride=2, lif=lif)
    l3 = EConvSpec("fc", l2.out_shape, 8, lif=lif)
    l4 = EConvSpec("fc", l3.out_shape, 3, lif=lif)
    return SNNSpec(layers=(l0, l1, l2, l3, l4), n_timesteps=n_timesteps,
                   n_classes=3)


# small boundaries: routing overflows, and drops are counted
NETWORK_CAPS = {"tiny": (24, 40, 24), "mini": (24, 16, 24, 8, 4)}


def network_case(net, pairing, tiles, seed, N=3, T=4, E=12,
                 pattern="random"):
    """One fused-network launch's inputs on the CPU, as numpy.

    ``net`` is ``"tiny"`` (conv first: halo coordinates) or ``"mini"``
    (:func:`mini_fig6`); the f32 pairing keeps float weights unquantized
    (accumulation order visible), the native one runs the quantized net.
    ``tiles`` None runs dense; ``"ones"`` passes all-hot bitmaps;
    ``"sparse"`` confines the events to a corner, starts every membrane
    below threshold and takes the bitmaps ``window_tile_maps`` propagates.
    Liveness is random.  ``pattern`` "random" draws unsorted events with
    0/1 gates; any of :data:`GATE_PATTERNS` (not with sparse bitmaps) takes
    layer 0's events and gates from :func:`_gate_pattern`.

    Returns ``(program, states, weights, xyc, gate, alive, tiles)``; the
    schedule is slot-major (conv: halo coordinates), ``tiles`` a list of
    per-layer bitmaps or None.
    """
    rng = np.random.default_rng(seed)
    spec = tiny_net() if net == "tiny" else mini_fig6()
    params = init_snn(rng, spec, device="cpu")
    native = pairing == "native"
    if native:
        q = quantize_net(params, spec)
        spec, params = q.spec, q.params_for("int8-native")
    prog = lp.compile_program(
        spec, step_capacities=NETWORK_CAPS[net], device="cpu",
        policy=ExecutionPolicy(dtype_policy="int8-native" if native
                               else "f32-carrier",
                               fusion_policy="fused-network"))
    corner = tiles == "sparse"
    states = []
    for op in prog.ops:
        shape = tuple(lp.padded_state(op, n_slots=N).shape)
        top = op.lif.threshold
        if native:
            clip = int(op.lif.state_clip)
            states.append(rng.integers(-clip, (int(top) - 1 if corner
                                               else clip) + 1, shape)
                          .astype(np.int8))
        else:
            v = (rng.standard_normal(shape) * 0.6).astype(np.float32)
            states.append(np.minimum(v, np.float32(top * 0.9)) if corner
                          else v)
    H, W, C = spec.in_shape
    hi = (H // 4, W // 4) if corner else (H, W)
    xyc = np.stack([rng.integers(0, hi[0], (T, N, E)),
                    rng.integers(0, hi[1], (T, N, E)),
                    rng.integers(0, C, (T, N, E))], -1).astype(np.int32)
    gate = (rng.random((T, N, E)) < 0.8).astype(np.float32)
    alive = (rng.random((N, T)) < 0.8).astype(np.float32)
    if pattern != "random":
        assert not corner, "sparse bitmaps need the corner's events"
        xyc, gate = _gate_pattern(np.random.default_rng(seed + 1000),
                                  pattern, T * N, E, (H, W, C),
                                  np.arange(T * N) % N,
                                  np.int32 if native else np.float32, True)
        xyc, gate = xyc.reshape(T, N, E, 3), gate.reshape(T, N, E)
    bitmaps = None
    if tiles == "ones":
        bitmaps = [np.ones((N, *tile_grid(*op.spec.out_shape[:2])[:2]),
                           np.int32) for op in prog.ops]
    if corner:
        bitmaps = [t.numpy() for t in lp.window_tile_maps(
            prog, _t(xyc), _t(gate))]
        assert 0 < bitmaps[0].sum() < bitmaps[0].size
    op0 = prog.ops[0]
    if op0.kind == "conv":
        xyc = xyc + np.asarray([op0.spec.padding, op0.spec.padding, 0],
                               np.int32)
    weights = [p.w.numpy() for p in params]
    return (prog, states, weights, xyc.transpose(1, 0, 2, 3),
            gate.transpose(1, 0, 2), alive, bitmaps)


def _record_cuts(monkeypatch, layers, slabs):
    """Spy on the plain version's routing: for every frame whose spikes
    pass the next layer's cap', the cluster rank (of ``CLUSTER``, as the
    kernel's ``share_of`` deals rows and columns) whose share holds the
    first dropped spike.  Returns the list the spy fills."""
    from repro_torch.kernels.network_window import ref as nw_ref
    frames = {(Hp - 2 * nl.halo, Wp - 2 * nl.halo, C): nl
              for nl, (Hp, Wp, C) in zip(layers, slabs)}
    assert len(frames) == len(layers), "frames must tell the layers apart"
    cuts, route = [], nw_ref.route_frame

    def spy(s, cap):
        nl = frames[tuple(s.shape[1:])]
        Wo, C = s.shape[2:4]
        for row in (s.reshape(s.shape[0], -1) != 0).cpu().numpy():
            idx = np.flatnonzero(row)
            if len(idx) > cap:
                f = int(idx[cap])
                if nl.kind == "fc":         # columns in blocks
                    rank = f // -(-C // CLUSTER)
                else:                        # slab rows dealt in turn
                    rank = (f // (Wo * C) + nl.halo) % CLUSTER
                cuts.append(rank)
        return route(s, cap)
    monkeypatch.setattr(nw_ref, "route_frame", spy)
    return cuts


@pytest.mark.gpu
@pytest.mark.parametrize("tiles,pattern,E", [
    (None, "random", 200), ("sparse", "random", 200),
    ("ones", "random", 1500)] + [("ones", p, 200) for p in GATE_PATTERNS])
@pytest.mark.parametrize("pairing", list(WINDOW_PAIRINGS))
@pytest.mark.parametrize("net", ["tiny", "mini"])
def test_cuda_network_window_matches_plain(cuda, monkeypatch, net, pairing,
                                           tiles, pattern, E):
    # E = 200 > 128 events; E = 1500 > a CTA's 1024-event stage: more than
    # one stage of layer 0 per timestep.  Both nets' slabs have rows that
    # do not divide by the cluster (tiny: conv 16 slab rows, pool 6, fc 4
    # columns; mini: conv 12 slab rows, fc 3 columns), so some CTAs own
    # nothing of a layer; tiny runs a conv first on the collector's
    # unsorted schedule; GATE_PATTERNS give layer 0 duplicates, non-unit
    # gates, holes, an empty slot and coordinates to clamp or drop.
    prog, states, weights, xyc, gate, alive, bitmaps = network_case(
        net, pairing, tiles, 12, N=4, T=4, E=E, pattern=pattern)
    native = pairing == "native"
    acc = torch.int32 if native else torch.float32
    args = ([_t(v).to(cuda) for v in states],
            [_t(w).to(cuda) for w in weights], _t(xyc).to(cuda),
            _t(gate).to(acc).to(cuda), _t(alive).to(cuda))
    kw = dict(layers=lp._net_layers(prog), native=native,
              tiles=None if bitmaps is None
              else [_t(b).to(cuda) for b in bitmaps])
    before = LAUNCHES["network_window"]
    got = network_window(*args, **kw)
    cuts = _record_cuts(monkeypatch, kw["layers"],
                        [tuple(v.shape[1:]) for v in states])
    want = network_window_ref(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["network_window"] == before + 1
    for g, x in zip(got[0] + got[1:], want[0] + want[1:]):
        assert g.dtype == x.dtype and torch.equal(g, x)
    assert int(got[3].sum()) > 0 or tiles == "sparse"
    if tiles is None:
        # a routing step whose cap' cut falls inside a later CTA's band
        assert cuts and max(cuts) >= 1, cuts


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 40, 40, 16), (1000, 7)])
@pytest.mark.parametrize("dt", [0, 1, 5])
@pytest.mark.parametrize("clip", [None, 3.0])
def test_cuda_lif_fused_matches_plain(cuda, shape, dt, clip):
    v, syn = lif_case(shape, dt)
    args = (_t(v).to(cuda), _t(syn).to(cuda),
            torch.tensor(float(dt), device=cuda), 0.1, 0.9, clip)
    before = LAUNCHES["lif_fused"]
    got = lif_fused(*args)
    want = lif_fused_ref(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["lif_fused"] == before + 1
    for g, x in zip(got, want):
        assert torch.equal(g, x)
