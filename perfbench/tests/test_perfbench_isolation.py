"""Nothing the benchmark loads brings in JAX or the JAX package (compared
by whole top-level name: ``repro_torch`` begins with ``repro``), and the
plain reference imports nothing of the port."""
import ast
import json
import os
import subprocess
import sys

import pytest

from perfbench import core

REPO = core.BENCH_DIR.parent
FILES = sorted(core.BENCH_DIR.rglob("*.py"))

PROBE = r"""
import contextlib, importlib.util, io, json, sys
spec = importlib.util.spec_from_file_location("run", "perfbench/run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
from perfbench import core, control
bench = json.load(open("BENCHMARK.json"))
for w in bench["workloads"]:
    core.resolve(w["name"])
# what the drivers import once a run starts
import repro_torch.serve.runtime, repro_torch.serve.event_engine
import repro_torch.train.snn_loop, repro_torch.core.quant
import repro_torch.core.layer_program, repro_torch.kernels._build
forbidden = core.forbidden_modules()
# then a run on a machine with no card (CUDA_VISIBLE_DEVICES is empty)
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = run.main(["--workload", "nmnist-closed", "--seed", str(2 ** 40 + 3),
                   "--seconds", "1", "--trace", "0"])
print(json.dumps({"forbidden": forbidden, "rc": rc,
                  "stdout": out.getvalue()}))
"""


def _roots(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    for f in FILES:
        assert not _roots(f) & set(core.FORBIDDEN), f


def test_the_reference_imports_nothing_of_the_port():
    for f in sorted((core.BENCH_DIR / "reference").rglob("*.py")):
        assert "repro_torch" not in _roots(f), f
        assert _roots(f) <= {"__future__", "math", "typing", "torch"}, f


@pytest.fixture(scope="module")
def probe():
    """One subprocess: the harness and all it finds loaded, then a run
    without a card."""
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO}",
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_loaded_harness_holds_no_forbidden_module(probe):
    assert probe["forbidden"] == []


def test_run_without_a_card_exits_with_no_result(probe):
    assert probe["rc"] != 0
    assert probe["stdout"].strip() == ""
