"""The port's three scatter kernels against the JAX reference.

The same numpy inputs go through the port's wrapper on CPU tensors (which
runs the plain PyTorch version) and through the JAX package's
``*_batched_ref`` oracle, under every dtype pairing of
``layer_program.scatter_dtypes``, with unquantized float weights (so the
accumulation order is visible), zero gates, pool VALID drops and empty
batches.  One interpret-mode Pallas check per kernel runs at the smallest
shape.  Every comparison is exact (``np.array_equal``, which counts -0.0
equal to +0.0: a gated-off event in the reference adds ``w * 0``, which
can flip the sign of a zero and nothing else; the port skips it).

The CUDA kernels themselves run only on a card: their tests carry the
``gpu`` marker and skip here.  The card's machine has no JAX, so this file
imports the reference lazily; there the card tests run with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_kernels.py
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.event_conv import event_conv_batched
from repro_torch.kernels.event_conv.ref import event_conv_batched_ref
from repro_torch.kernels.event_fc import event_fc_batched
from repro_torch.kernels.event_fc.ref import event_fc_batched_ref
from repro_torch.kernels.event_pool import event_pool_batched
from repro_torch.kernels.event_pool.ref import event_pool_batched_ref

torch.set_num_threads(1)

# (slab dtype, weight dtype, gate dtype, accumulator) per pairing
PAIRINGS = {
    "f32": (np.float32, np.float32, np.float32, np.float32),
    "int8": (np.int8, np.int8, np.int8, np.int32),
    "int32": (np.int32, np.int8, np.int32, np.int32),
}


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


def test_pool_valid_rule_drops_past_the_grid():
    v = np.zeros((1, 3, 3, 1), np.float32)       # 7 // 2 = 3 output rows
    w = np.ones((1,), np.float32)
    xyc = np.asarray([[[6, 6, 0], [0, 0, 0], [6, 1, 0]]], np.int32)
    gate = np.ones((1, 3), np.float32)
    got = event_pool_batched(_t(v), _t(w), _t(xyc), _t(gate), 2).numpy()
    np.testing.assert_array_equal(got, _jax("pool", v, w, xyc, gate, 2,
                                            out=np.float32))
    assert got[0, 0, 0, 0] == 1.0 and got.sum() == 1.0


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
