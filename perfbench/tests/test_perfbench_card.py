"""On the card: a short run of every cell prints a correct result line
(``python -m pytest -q --noconftest -m gpu perfbench/tests`` there; skips
without a card)."""
import json
import subprocess
import sys

import pytest
import torch

from perfbench import core
from perfbench.tests.test_perfbench_layout import WORKLOADS


@pytest.mark.gpu
@pytest.mark.parametrize("name", WORKLOADS)
def test_short_run_is_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          name, "--seed", str(2 ** 35 + 1), "--seconds",
                          "2", "--trace", "0"], cwd=core.BENCH_DIR.parent,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
