"""The port stands alone: no JAX, no reference package, no quiet CPU.

* An AST scan of every file under ``src/repro_torch/`` and of
  ``chip_smoke.py`` finds no import of ``jax`` or of ``repro`` (the JAX
  package) — only the ``tests/test_torch_*.py`` files import both.
* The entry points default to the CUDA device and raise on a machine
  without one instead of carrying on on the CPU.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.core.layer_program import compile_program
from repro_torch.core.policies import ExecutionPolicy
from repro_torch.core.sne_net import init_snn, tiny_net
from repro_torch.data.events_ds import sample_recording_path
from repro_torch.serve import EventServeEngine
from repro_torch.weights import load_net, params_from_numpy

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


@pytest.mark.parametrize("entry", ["compile_program", "engine", "load_net",
                                   "params_from_numpy", "init_snn"])
def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, entry):
    spec = tiny_net()
    params = init_snn(np.random.default_rng(0), spec, device="cpu")
    calls = {
        "compile_program": lambda: compile_program(spec),
        "engine": lambda: EventServeEngine(spec, params, n_slots=2,
                                           policy=ExecutionPolicy(
                                               fusion_policy="per-step")),
        "load_net": lambda: load_net(
            sample_recording_path("tiny_gesture_trained.npz"), spec),
        "params_from_numpy": lambda: params_from_numpy(
            [p.w.numpy() for p in params], spec),
        "init_snn": lambda: init_snn(np.random.default_rng(0), spec),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_the_cuda_wrappers_refuse_mixed_devices():
    # a CPU slab with a device that is not the CPU never reaches the plain
    # version: the meta device stands in for a CUDA tensor here
    from repro_torch.kernels.event_fc import event_fc_batched
    v = torch.zeros((1, 1, 1, 4))
    w = torch.zeros((8, 4), device="meta")
    xyc = torch.zeros((1, 2, 3), dtype=torch.int32)
    gate = torch.ones((1, 2))
    with pytest.raises(ValueError, match="expected CUDA"):
        event_fc_batched(v, w, xyc, gate, (2, 2, 2))
