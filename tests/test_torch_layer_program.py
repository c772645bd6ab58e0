"""The port's layer-program executor against the JAX reference.

`window_step` on `tiny_net` (3 slots, one slot frozen mid-window, nonzero
deferred idle decay, random starting membranes) must equal the reference's
``window_step(use_pallas=False)`` bitwise — membranes, class counts,
per-layer event counts and drops — under both dtype policies (float
weights left unquantized on the float32 carrier, so accumulation order is
visible; int4 codes on the int8-native path), under the per-step and the
fused-window lowering, tile sparsity on and off.  The fused lowering must
also equal the port's own per-step one; on the "corner" schedule (events
in one corner, membranes below threshold, as in serving) the tile bitmaps
are genuinely sparse.
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
from repro.core.lif import LifParams as JLif
from repro.core.policies import ExecutionPolicy as JPolicy
from repro.core.sne_net import dvs_gesture_net as jdvs
from repro.core.sne_net import nmnist_net as jnmnist
from repro.core.sne_net import tiny_net as jtiny
from repro_torch.core import layer_program as lp
from repro_torch.core.econv import EConvParams
from repro_torch.core.policies import ExecutionPolicy
from repro_torch.core.quant import quantize_net
from repro_torch.core.sne_net import (dvs_gesture_net, init_snn, nmnist_net,
                                      tiny_net)

torch.set_num_threads(1)
PER_STEP = ExecutionPolicy(fusion_policy="per-step")


@pytest.mark.parametrize("nets", [(tiny_net, jtiny), (dvs_gesture_net, jdvs),
                                  (nmnist_net, jnmnist)])
def test_capacities_and_geometry_match_jax(nets):
    spec, jspec = nets[0](), nets[1]()
    prog = lp.compile_program(spec, policy=PER_STEP, device="cpu")
    jprog = jlp.compile_program(spec=jspec, policy=JPolicy(
        fusion_policy="per-step"))
    assert prog.step_capacities == jprog.step_capacities
    for op, jop in zip(prog.ops, jprog.ops):
        assert (op.halo, op.kind) == (jop.halo, jop.kind)
        assert tuple(lp.padded_state(op, n_slots=2).shape) == tuple(
            jlp.padded_state(jop, n_slots=2).shape)
        assert lp.layer_stream_capacity(op.spec, 100) == \
            jlp.layer_stream_capacity(jop.spec, 100)


@pytest.mark.parametrize("fusion", ["per-step", "fused-window",
                                    "fused-network"])
def test_every_fusion_policy_compiles_and_unknown_is_refused(fusion):
    prog = lp.compile_program(tiny_net(), device="cpu",
                              policy=ExecutionPolicy(fusion_policy=fusion))
    assert prog.fusion_policy == lp.effective_fusion(prog) == fusion
    with pytest.raises(ValueError, match="unknown fusion policy"):
        ExecutionPolicy(fusion_policy=fusion + "-bis")
    # a policy value that slipped past its own check is refused too
    pol = ExecutionPolicy(fusion_policy=fusion)
    object.__setattr__(pol, "fusion_policy", fusion + "-bis")
    with pytest.raises(ValueError, match="unknown fusion policy"):
        lp.compile_program(tiny_net(), device="cpu", policy=pol)


def test_native_policy_refuses_float_specs_and_weights():
    with pytest.raises(ValueError, match="int8-native requires"):
        lp.compile_program(tiny_net(), device="cpu", policy=ExecutionPolicy(
            dtype_policy="int8-native", fusion_policy="per-step"))
    spec = tiny_net()
    q = quantize_net(init_snn(np.random.default_rng(0), spec, device="cpu"),
                     spec)
    prog = lp.compile_program(q.spec, device="cpu", policy=ExecutionPolicy(
        dtype_policy="int8-native", fusion_policy="per-step"))
    with pytest.raises(ValueError, match="integer weight codes"):
        lp.check_native_weights(prog.ops[0], q.params_for("f32-carrier")[0])


def _inputs(prog, rng, N, W, E, native, corner=False):
    """Random starting membranes and a window of layer-0 events; with
    ``corner``, events in the top-left quarter and every membrane below
    its threshold (the serving invariant tile sparsity rests on)."""
    states = []
    for op in prog.ops:
        shape = tuple(lp.padded_state(op, n_slots=N).shape)
        if native:
            clip = int(op.lif.state_clip)
            top = int(op.lif.threshold) - 1 if corner else clip
            states.append(rng.integers(-clip, top + 1, shape)
                          .astype(np.int8))
        else:
            v = (rng.standard_normal(shape) * 0.6).astype(np.float32)
            if corner:
                v = np.minimum(v, np.float32(op.lif.threshold * 0.9))
            states.append(v)
    H, Wd, C = prog.spec.in_shape
    hi = (H // 4, Wd // 4) if corner else (H, Wd)
    xyc = np.stack([rng.integers(0, hi[0], (W, N, E)),
                    rng.integers(0, hi[1], (W, N, E)),
                    rng.integers(0, C, (W, N, E))], -1).astype(np.int32)
    gate = (rng.random((W, N, E)) < 0.7).astype(np.float32)
    gate[:, 1, E // 2:] = 0.0                     # a short bucket
    alive = np.ones((W, N), np.float32)
    alive[W // 2:, 2] = 0.0                       # slot 2 frozen mid-window
    pre_dt = np.asarray([0, 3, 1], np.int64)[:N]
    cc = rng.integers(0, 3, (N, prog.spec.n_classes)).astype(np.float32)
    return states, cc, xyc, gate, alive, pre_dt


@pytest.mark.parametrize("schedule", ["uniform", "corner"])
@pytest.mark.parametrize("fusion,tile_sparsity", [
    ("per-step", True), ("fused-window", True), ("fused-window", False)])
@pytest.mark.parametrize("dtype_policy", ["f32-carrier", "int8-native"])
def test_window_step_matches_jax(dtype_policy, fusion, tile_sparsity,
                                 schedule):
    native = dtype_policy == "int8-native"
    spec, jspec = tiny_net(), jtiny()
    rng = np.random.default_rng(11)
    arrays = [p.w.numpy() for p in init_snn(rng, spec, device="cpu")]
    if native:
        # the port's lowering (bitwise the reference's: test_torch_core)
        # feeds both executors the same codes and integer LIF plan
        q = quantize_net([EConvParams(w=torch.from_numpy(a))
                          for a in arrays], spec)
        spec = q.spec
        jspec = dataclasses.replace(jspec, layers=tuple(
            dataclasses.replace(jl, lif=JLif(**dataclasses.asdict(l.lif)))
            for jl, l in zip(jspec.layers, spec.layers)))
        params = q.params_for(dtype_policy)
        jparams = [JParams(w=jnp.asarray(p.w.numpy())) for p in params]
    else:
        params = [EConvParams(w=torch.from_numpy(a)) for a in arrays]
        jparams = [JParams(w=jnp.asarray(a)) for a in arrays]
    pol = ExecutionPolicy(dtype_policy=dtype_policy, fusion_policy=fusion,
                          tile_sparsity=tile_sparsity)
    prog = lp.compile_program(spec, policy=pol, device="cpu")
    step_prog = lp.compile_program(spec, device="cpu", policy=(
        dataclasses.replace(pol, fusion_policy="per-step")))
    jprog = jlp.compile_program(jspec, policy=JPolicy(**dataclasses.asdict(
        pol)))
    states, cc, xyc, gate, alive, pre_dt = _inputs(
        prog, rng, 3, 4, 40 if schedule == "uniform" else 12, native,
        corner=schedule == "corner")
    if schedule == "corner" and prog.tile_sparsity:
        tiles = lp.window_tile_maps(prog, torch.from_numpy(xyc),
                                    torch.from_numpy(gate))
        assert 0 < int(tiles[0].sum()) < tiles[0].numel()
    t_states = tuple(torch.from_numpy(s) for s in states)
    j_states = tuple(jnp.asarray(s) for s in states)
    s_states = t_states
    t_cc, j_cc = torch.from_numpy(cc), jnp.asarray(cc)
    s_cc = t_cc
    # jitted like the reference engine runs it (one compile, not op by op)
    jstep = jax.jit(functools.partial(jlp.window_step, program=jprog,
                                      use_pallas=False))
    for window in range(2):                       # two windows back to back
        pre = pre_dt if window == 0 else np.zeros_like(pre_dt)
        t_states, t_cc, counts, drops = lp.window_step(
            params, t_states, t_cc, torch.from_numpy(xyc),
            torch.from_numpy(gate), torch.from_numpy(alive),
            torch.from_numpy(pre), program=prog)
        j_states, j_cc, jcounts, jdrops = jstep(
            jparams, j_states, j_cc, jnp.asarray(xyc), jnp.asarray(gate),
            jnp.asarray(alive), jnp.asarray(pre))
        for a, b in zip(t_states, j_states):
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(t_cc.numpy(), np.asarray(j_cc))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        np.testing.assert_array_equal(drops.numpy(), np.asarray(jdrops))
        if fusion == "per-step" or (schedule == "uniform"
                                    and prog.tile_sparsity):
            continue    # membranes above threshold break the tile contract
        # the port's per-step lowering is the bitwise oracle of the fused
        s_states, s_cc, s_counts, s_drops = lp.window_step(
            params, s_states, s_cc, torch.from_numpy(xyc),
            torch.from_numpy(gate), torch.from_numpy(alive),
            torch.from_numpy(pre), program=step_prog)
        for a, b in zip(t_states + (t_cc, counts, drops),
                        s_states + (s_cc, s_counts, s_drops)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the layer program's byte accounting
# ---------------------------------------------------------------------------

ACCOUNTING_NETS = {
    "tiny_net": (tiny_net, jtiny),
    "fig6_16x16": (lambda: dvs_gesture_net(n_timesteps=8, height=16,
                                           width=16),
                   lambda: jdvs(n_timesteps=8, height=16, width=16))}


def _both_specs(name, dtype_policy):
    """The port's spec and the reference's, the int4 lowering's integer
    LIF plan in both under int8-native."""
    spec, jspec = (f() for f in ACCOUNTING_NETS[name])
    if dtype_policy == "int8-native":
        spec = quantize_net(init_snn(np.random.default_rng(0), spec,
                                     device="cpu"), spec).spec
        jspec = dataclasses.replace(jspec, layers=tuple(
            dataclasses.replace(jl, lif=JLif(**dataclasses.asdict(l.lif)))
            for jl, l in zip(jspec.layers, spec.layers)))
    return spec, jspec


@pytest.mark.parametrize("dtype_policy", ["f32-carrier", "int8-native"])
@pytest.mark.parametrize("name", list(ACCOUNTING_NETS))
def test_launch_and_state_bytes_equal_the_reference(name, dtype_policy):
    # exact, to the byte: the same formula over the same dtypes
    spec, jspec = _both_specs(name, dtype_policy)
    pol = ExecutionPolicy(dtype_policy=dtype_policy)
    prog = lp.compile_program(spec, policy=pol, device="cpu")
    jprog = jlp.compile_program(jspec, policy=JPolicy(**dataclasses.asdict(
        pol)))
    for op, jop in zip(prog.ops, jprog.ops):
        for n_slots, n_events in ((1, 8), (4, 128), (8, 1000)):
            assert lp.scatter_launch_bytes(op, n_slots, n_events) == \
                jlp.scatter_launch_bytes(jop, n_slots, n_events), \
                (op.index, n_slots, n_events)
    for n_slots in (1, 2, 8):
        assert lp.state_bytes(prog, n_slots) == \
            jlp.state_bytes(jprog, n_slots)
        # the engine's resident slabs are exactly that many bytes
        assert lp.state_bytes(prog, n_slots) == sum(
            lp.padded_state(op, n_slots=n_slots).nbytes for op in prog.ops)


@pytest.mark.parametrize("name", list(ACCOUNTING_NETS))
def test_validate_policy_spec_raises_where_the_reference_does(name):
    spec, jspec = _both_specs(name, "f32-carrier")
    qspec, jqspec = _both_specs(name, "int8-native")
    def bent(sp, **kw):
        # layer 1's LIF changed: a clip past int8, or a fractional threshold
        lif = dataclasses.replace(sp.layers[1].lif, **kw)
        return dataclasses.replace(sp, layers=sp.layers[:1] + (
            dataclasses.replace(sp.layers[1], lif=lif),) + sp.layers[2:])
    cases = [(spec, jspec, "f32-carrier"), (qspec, jqspec, "f32-carrier"),
             (qspec, jqspec, "int8-native"), (spec, jspec, "int8-native"),
             (spec, jspec, "int4")]
    for kw in ({"state_clip": 200.0}, {"threshold": 2.5}):
        cases.append((bent(qspec, **kw), bent(jqspec, **kw), "int8-native"))
    raised = []
    for s, js, dp in cases:
        try:
            jlp.validate_policy_spec(js, dp)
            want = None
        except ValueError as e:
            want = str(e)
        if want is None:
            lp.validate_policy_spec(s, dp)
        else:
            with pytest.raises(ValueError) as got:
                lp.validate_policy_spec(s, dp)
            assert str(got.value) == want
        raised.append(want is not None)
    assert raised == [False, False, False, True, True, True, True]


@pytest.mark.parametrize("dtype_policy", ["f32-carrier", "int8-native"])
@pytest.mark.parametrize("name", list(ACCOUNTING_NETS))
def test_window_scratch_bytes_are_the_wrappers_block_sizes(name,
                                                           dtype_policy):
    from repro_torch.kernels.event_conv.ops import conv_plan, conv_smem
    from repro_torch.kernels.event_fc.ops import FC_SMEM
    from repro_torch.kernels.event_pool.ops import pool_smem
    from repro_torch.kernels.network_window import SMEM_BUDGET
    spec, _ = _both_specs(name, dtype_policy)
    got = {}
    for fusion in ("per-step", "fused-window", "fused-network"):
        prog = lp.compile_program(spec, device="cpu", policy=ExecutionPolicy(
            dtype_policy=dtype_policy, fusion_policy=fusion))
        window = fusion == "fused-window"
        sizes = []
        for op in prog.ops:
            s = op.spec
            for n in range(1, 5):
                if s.kind == "conv":
                    Hp, Wp = (d + 2 * op.halo for d in s.out_shape[:2])
                    rows, cb = conv_plan(n, Hp, Wp, s.out_channels, s.kernel,
                                         s.in_shape[2], window=window)
                    sizes.append(conv_smem(rows, Wp, cb, s.kernel,
                                           s.in_shape[2], window=window))
                elif s.kind == "pool":
                    sizes.append(pool_smem(int(np.prod(s.out_shape)),
                                           window=window))
                else:
                    sizes.append(FC_SMEM)
        want = (lp.network_window_plan(prog).smem_bytes
                if fusion == "fused-network" else max(sizes))
        got[fusion] = lp.window_scratch_bytes(prog, 4, n_slots=4)
        assert got[fusion] == want
        # n_timesteps and co_blk change nothing on this card
        assert lp.window_scratch_bytes(prog, 100, co_blk=8, n_slots=4) == want
        assert 0 < want <= SMEM_BUDGET
    # the window kernels add their tile bits to the per-step blocks
    assert got["fused-window"] > got["per-step"]
