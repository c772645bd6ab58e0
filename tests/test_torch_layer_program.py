"""The port's per-step layer-program executor against the JAX reference.

`window_step` on `tiny_net` (3 slots, one slot frozen mid-window, nonzero
deferred idle decay, random starting membranes) must equal the reference's
``window_step(use_pallas=False)`` bitwise — membranes, class counts,
per-layer event counts and drops — under both dtype policies: float
weights left unquantized on the float32 carrier (accumulation order is
visible) and int4 codes on the int8-native path.
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


@pytest.mark.parametrize("fusion,item", [("fused-window", "item 4"),
                                         ("fused-network", "item 5")])
def test_fused_policies_are_refused(fusion, item):
    with pytest.raises(NotImplementedError, match=item):
        lp.compile_program(tiny_net(), device="cpu",
                           policy=ExecutionPolicy(fusion_policy=fusion))


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


def _inputs(prog, rng, N, W, E, native):
    """Random starting membranes and a window of layer-0 events."""
    states = []
    for op in prog.ops:
        shape = tuple(lp.padded_state(op, n_slots=N).shape)
        if native:
            clip = int(op.lif.state_clip)
            states.append(rng.integers(-clip, clip + 1, shape)
                          .astype(np.int8))
        else:
            states.append((rng.standard_normal(shape) * 0.6)
                          .astype(np.float32))
    H, Wd, C = prog.spec.in_shape
    xyc = np.stack([rng.integers(0, H, (W, N, E)),
                    rng.integers(0, Wd, (W, N, E)),
                    rng.integers(0, C, (W, N, E))], -1).astype(np.int32)
    gate = (rng.random((W, N, E)) < 0.7).astype(np.float32)
    gate[:, 1, E // 2:] = 0.0                     # a short bucket
    alive = np.ones((W, N), np.float32)
    alive[W // 2:, 2] = 0.0                       # slot 2 frozen mid-window
    pre_dt = np.asarray([0, 3, 1], np.int64)[:N]
    cc = rng.integers(0, 3, (N, prog.spec.n_classes)).astype(np.float32)
    return states, cc, xyc, gate, alive, pre_dt


@pytest.mark.parametrize("dtype_policy", ["f32-carrier", "int8-native"])
def test_window_step_matches_jax(dtype_policy):
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
    pol = ExecutionPolicy(dtype_policy=dtype_policy, fusion_policy="per-step")
    prog = lp.compile_program(spec, policy=pol, device="cpu")
    jprog = jlp.compile_program(jspec, policy=JPolicy(**dataclasses.asdict(
        pol)))
    states, cc, xyc, gate, alive, pre_dt = _inputs(prog, rng, 3, 4, 40,
                                                   native)
    t_states = tuple(torch.from_numpy(s) for s in states)
    j_states = tuple(jnp.asarray(s) for s in states)
    t_cc, j_cc = torch.from_numpy(cc), jnp.asarray(cc)
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
