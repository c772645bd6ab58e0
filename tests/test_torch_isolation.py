"""The port stands alone: no JAX, no reference package, no quiet CPU.

* An AST scan of every file under ``src/repro_torch/`` and of
  ``chip_smoke.py`` finds no import of ``jax`` or of ``repro`` (the JAX
  package) — only the ``tests/test_torch_*.py`` files import both.
* The entry points default to the CUDA device and raise on a machine
  without one instead of carrying on on the CPU; so does every example's
  ``main`` given no ``--device``.  The launchers' entries
  cover their host mode; ``--production-lower`` is the dry-run, which
  runs on ``meta`` tensors and needs no card
  (``tests/test_torch_dryrun.py``).
* ``meta`` is a device only where a caller names it: ``resolve_device``
  takes it, its default stays CUDA, and ``make_production_mesh`` builds
  its 256 or 512 meta devices without touching a card.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import events as ev
from repro_torch.core.econv import event_forward
from repro_torch.core.layer_program import compile_program
from repro_torch.core.policies import ExecutionPolicy
from repro_torch.core.sne_net import (default_capacities, event_apply,
                                      event_predict, init_snn, tiny_net)
from repro_torch.data.events_ds import TINY, batch_at, sample_recording_path
from repro_torch.distributed import Mesh
from repro_torch.examples import (event_sparsity, quickstart, serve_events,
                                  serve_lm, train_dvs_gesture)
from repro_torch.data.lm_ds import LmDatasetSpec
from repro_torch.data.lm_ds import batch_at as lm_batch_at
from repro_torch.data.lm_ds import stream as lm_stream
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.optim.schedules import constant
from repro_torch.train.loop import init_train_state, train_loop
from repro_torch.models.transformer import init_cache, init_model
from repro_torch.serve import EventServeEngine, ServeEngine
from repro_torch.train.snn_loop import (TrainConfig, evaluate, fit,
                                        load_trained_tiny)
from repro_torch.weights import (lm_params_from_numpy,
                                 lm_train_state_from_numpy, load_net,
                                 params_from_numpy)

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_the_reference():
    assert len(PORT_FILES) > 20
    scanned = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/kernels/window_common.py",
            "src/repro_torch/kernels/event_conv/ops.py",
            "src/repro_torch/kernels/network_window/ops.py",
            "src/repro_torch/kernels/network_window/ref.py",
            "src/repro_torch/kernels/lif/ops.py",
            "src/repro_torch/core/layer_program.py",
            "src/repro_torch/optim/optimizers.py",
            "src/repro_torch/optim/schedules.py",
            "src/repro_torch/train/checkpoint.py",
            "src/repro_torch/train/fault.py",
            "src/repro_torch/train/snn_loop.py",
            "src/repro_torch/models/transformer.py",
            "src/repro_torch/models/attention.py",
            "src/repro_torch/models/recurrent.py",
            "src/repro_torch/models/moe.py",
            "src/repro_torch/models/xlstm.py",
            "src/repro_torch/models/quant_lm.py",
            "src/repro_torch/models/frontend.py",
            "src/repro_torch/configs/olmoe_1b_7b.py",
            "src/repro_torch/configs/llama4_maverick.py",
            "src/repro_torch/configs/xlstm_1_3b.py",
            "src/repro_torch/configs/whisper_medium.py",
            "src/repro_torch/configs/internvl2_26b.py",
            "src/repro_torch/core/sd_decode.py",
            "src/repro_torch/core/lm_events.py",
            "src/repro_torch/serve/engine.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/train/loop.py",
            "src/repro_torch/data/lm_ds.py",
            "src/repro_torch/weights.py",
            "src/repro_torch/distributed/mesh.py",
            "src/repro_torch/distributed/collectives.py",
            "src/repro_torch/distributed/compression.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/launch/specs.py",
            "src/repro_torch/launch/hlo_analysis.py",
            "src/repro_torch/models/scan_util.py",
            "src/repro_torch/configs/sne_dvsgesture.py",
            "src/repro_torch/examples/quickstart.py",
            "src/repro_torch/examples/event_sparsity.py",
            "src/repro_torch/examples/train_dvs_gesture.py",
            "src/repro_torch/examples/serve_events.py",
            "src/repro_torch/examples/serve_lm.py",
            "chip_smoke.py"} <= scanned
    offenders = {str(p.relative_to(ROOT)): sorted(
        _imported_roots(p) & {"jax", "jaxlib", "repro"}) for p in PORT_FILES}
    assert not {k: v for k, v in offenders.items() if v}


def test_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import numpy\nfrom repro.core import lif\n"
                   "import jax.numpy as jnp\n")
    assert _imported_roots(bad) >= {"repro", "jax"}


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the machine without a CUDA card")


@pytest.mark.parametrize("entry", ["compile_program", "compile_fused",
                                   "compile_network", "engine",
                                   "engine_default", "engine_network",
                                   "engine_mesh",
                                   "load_net", "params_from_numpy",
                                   "init_snn", "fit", "evaluate", "batch_at",
                                   "load_trained_tiny", "event_forward",
                                   "event_apply", "event_predict",
                                   "lm_engine", "init_model",
                                   "lm_params_from_numpy", "launch_serve",
                                   "lm_engine_moe", "lm_engine_xlstm",
                                   "init_model_encoder", "init_cache_xlstm",
                                   "launch_serve_moe", "init_train_state",
                                   "train_loop", "lm_batch_at", "lm_stream",
                                   "launch_train", "launch_train_stub",
                                   "lm_train_state_from_numpy", "mesh",
                                   "make_host_mesh", "example_quickstart",
                                   "example_event_sparsity",
                                   "example_train_dvs_gesture",
                                   "example_serve_events",
                                   "example_serve_events_mesh",
                                   "example_serve_lm"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, entry):
    spec = tiny_net()
    params = init_snn(np.random.default_rng(0), spec, device="cpu")
    stream = ev.dense_to_events(torch.zeros((16, 12, 12, 2)), 8)
    caps = default_capacities(spec)
    lm_cfg = get_smoke("recurrentgemma-2b")
    lm_params = init_model(torch.Generator(), lm_cfg, device="cpu")
    calls = {
        "compile_program": lambda: compile_program(spec),
        "compile_fused": lambda: compile_program(
            spec, policy=ExecutionPolicy()),
        "engine": lambda: EventServeEngine(spec, params, n_slots=2,
                                           policy=ExecutionPolicy(
                                               fusion_policy="per-step")),
        "engine_default": lambda: EventServeEngine(spec, params, n_slots=2),
        "engine_mesh": lambda: EventServeEngine(
            spec, params, n_slots=2, policy=ExecutionPolicy(backend="mesh")),
        "compile_network": lambda: compile_program(
            spec, policy=ExecutionPolicy(fusion_policy="fused-network")),
        "engine_network": lambda: EventServeEngine(
            spec, params, n_slots=2,
            policy=ExecutionPolicy(fusion_policy="fused-network")),
        "load_net": lambda: load_net(
            sample_recording_path("tiny_gesture_trained.npz"), spec),
        "params_from_numpy": lambda: params_from_numpy(
            [p.w.numpy() for p in params], spec),
        "init_snn": lambda: init_snn(np.random.default_rng(0), spec),
        "fit": lambda: fit(spec, TINY, TrainConfig(steps=1, batch=1)),
        "evaluate": lambda: evaluate(spec, params, TINY, n=1),
        "batch_at": lambda: batch_at(0, 0, 1, TINY),
        "load_trained_tiny": lambda: load_trained_tiny(),
        "event_forward": lambda: event_forward(params[0], spec.layers[0],
                                               stream, 16, 16),
        "event_apply": lambda: event_apply(params, spec, stream, caps),
        "event_predict": lambda: event_predict(params, spec, stream, caps),
        "lm_engine": lambda: ServeEngine(lm_cfg, lm_params, batch_slots=2,
                                         cache_len=16),
        "init_model": lambda: init_model(torch.Generator(), lm_cfg),
        # the device is resolved before the tree is read
        "lm_params_from_numpy": lambda: lm_params_from_numpy({}, lm_cfg),
        "launch_serve": lambda: launch_serve.main(
            ["--arch", "recurrentgemma-2b", "--requests", "1"]),
        "lm_engine_moe": lambda: ServeEngine(
            get_smoke("olmoe-1b-7b"), {}, batch_slots=2, cache_len=16),
        "lm_engine_xlstm": lambda: ServeEngine(
            get_smoke("xlstm-1.3b"), {}, batch_slots=2, cache_len=16),
        "init_model_encoder": lambda: init_model(
            torch.Generator(), get_smoke("whisper-medium")),
        "init_cache_xlstm": lambda: init_cache(get_smoke("xlstm-1.3b"), 2,
                                               16),
        "launch_serve_moe": lambda: launch_serve.main(
            ["--arch", "llama4-maverick-400b-a17b", "--requests", "1"]),
        "init_train_state": lambda: init_train_state(torch.Generator(),
                                                     lm_cfg),
        "train_loop": lambda: train_loop(lm_cfg, iter([]), 1,
                                         constant(1e-3)),
        "lm_batch_at": lambda: lm_batch_at(LmDatasetSpec(512, 8), 0, 0, 2),
        "lm_stream": lambda: next(lm_stream(LmDatasetSpec(512, 8), 0, 2)),
        "launch_train": lambda: launch_train.main(
            ["--arch", "gemma3-1b", "--smoke", "--steps", "1"]),
        "launch_train_stub": lambda: launch_train.main(
            ["--arch", "whisper-medium", "--smoke", "--steps", "1"]),
        "lm_train_state_from_numpy": lambda: lm_train_state_from_numpy(
            {}, None, lm_cfg),
        "mesh": lambda: Mesh((2, 2)),
        "make_host_mesh": lambda: make_host_mesh(),
        # the examples, called with no --device
        "example_quickstart": lambda: quickstart.main([]),
        "example_event_sparsity": lambda: event_sparsity.main([]),
        "example_train_dvs_gesture": lambda: train_dvs_gesture.main(
            ["--steps", "1", "--test-n", "1"]),
        "example_serve_events": lambda: serve_events.main(
            ["--source", "file", "--weights", "trained"]),
        "example_serve_events_mesh": lambda: serve_events.main(
            ["--backend", "mesh"]),
        "example_serve_lm": lambda: serve_lm.main(["--requests", "1"]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_meta_is_a_device_only_when_named(no_cuda):
    assert resolve_device("meta") == torch.device("meta")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("xpu")


def test_production_mesh_touches_no_card(no_cuda, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the production mesh asked for a card")
    monkeypatch.setattr(torch.cuda, "device_count", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    single, multi = (make_production_mesh(),
                     make_production_mesh(multi_pod=True))
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert set(multi.devices) == {torch.device("meta")}
    assert len(multi.devices) == 512


def test_the_cuda_wrappers_refuse_mixed_devices():
    # a CPU slab with a device that is not the CPU never reaches the plain
    # version: the meta device stands in for a CUDA tensor here
    from repro_torch.core.lif import LifParams
    from repro_torch.kernels.event_fc import event_fc_batched, event_fc_window
    v = torch.zeros((1, 1, 1, 4))
    w = torch.zeros((8, 4), device="meta")
    xyc = torch.zeros((1, 2, 3), dtype=torch.int32)
    gate = torch.ones((1, 2))
    with pytest.raises(ValueError, match="expected CUDA"):
        event_fc_batched(v, w, xyc, gate, (2, 2, 2))
    with pytest.raises(ValueError, match="expected CUDA"):
        event_fc_window(v, w, xyc[:, None], gate[:, None], torch.ones((1, 1)),
                        lif=LifParams(), in_shape=(2, 2, 2))
    from repro_torch.kernels.lif import lif_fused
    with pytest.raises(ValueError, match="expected CUDA"):
        lif_fused(v, torch.zeros((1, 1, 1, 4), device="meta"), 1.0, 0.1, 0.9)
