"""The benchmark is driven by data: every cell of ``BENCHMARK.json``
resolves to its files by name, a mix added as a file is found without an
edit, and the file keeps to the benchmark contract's shapes."""
import json
import re
import shutil

import pytest

from perfbench import core
from perfbench.program import snn_spec

BENCH = json.loads((core.BENCH_DIR.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_resolves_by_name(name):
    cell = core.resolve(name)
    assert cell.config["name"] == cell.workload["config"]
    assert callable(cell.driver.run)
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        r = cell.readers[m["name"]]
        assert (r.NAME, r.UNIT, r.LAYER, r.MOVES) == (
            m["name"], m["unit"], m["layer"], m["moves"])
        assert r.TRACED
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])


def slayer_nmnist_net():
    """SLAYER's N-MNIST network 34x34x2-12c5-2a-64c5-2a-10o (no padding),
    T = 60, in the port's layer types."""
    from repro_torch.core.econv import EConvSpec
    from repro_torch.core.lif import LifParams
    from repro_torch.core.sne_net import SNNSpec

    def lif(th):
        return LifParams(threshold=th, leak=0.03125)
    l1 = EConvSpec("conv", (34, 34, 2), 12, kernel=5, lif=lif(1.0))
    l2 = EConvSpec("pool", l1.out_shape, 12, kernel=2, stride=2,
                   lif=lif(0.999))
    l3 = EConvSpec("conv", l2.out_shape, 64, kernel=5, lif=lif(1.0))
    l4 = EConvSpec("pool", l3.out_shape, 64, kernel=2, stride=2,
                   lif=lif(0.999))
    l5 = EConvSpec("fc", l4.out_shape, 10, lif=lif(1.0))
    assert [l.out_shape for l in (l1, l2, l3, l4)] == [
        (30, 30, 12), (15, 15, 12), (11, 11, 64), (5, 5, 64)]
    return SNNSpec(layers=(l1, l2, l3, l4, l5), n_timesteps=60,
                   n_classes=10)


def dvs_gesture_net():
    from repro_torch.core import sne_net
    return sne_net.dvs_gesture_net()


@pytest.mark.parametrize("config,factory", [
    ("fig6-dvsgesture", dvs_gesture_net), ("nmnist", slayer_nmnist_net)])
def test_config_is_the_published_net(config, factory):
    cfg = json.loads((core.BENCH_DIR / "configs" / f"{config}.json")
                     .read_text())
    spec = snn_spec(cfg)
    assert spec == factory()
    # the harness's own geometry (the reference's) is the port's
    from perfbench import inputs
    assert [l["out_shape"] for l in inputs.layer_shapes(cfg)] == [
        l.out_shape for l in spec.layers]


def test_a_mix_added_as_a_file_is_found(tmp_path):
    """A later PR adds a cell with a traffic file and a workload entry; no
    file that is there changes."""
    shutil.copytree(core.BENCH_DIR, tmp_path / core.BENCH_DIR.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / core.BENCH_DIR.name).rglob("*")
              if p.is_file()}
    mix = dict(json.loads((core.BENCH_DIR / "traffic" / "closed-a4.9.json")
                          .read_text()), rate_hz=1_800_000.0)
    (tmp_path / "perfbench" / "traffic" / "closed-a2.6.json").write_text(
        json.dumps(mix))
    bench["workloads"] = BENCH["workloads"] + [{
        "name": "fig6-a2.6-closed", "config": "fig6-dvsgesture",
        "traffic": "closed-a2.6", "chips": 1, "why": "a test cell"}]
    bench["end_to_end"] = [dict(m, workloads=m["workloads"]
                                + ["fig6-a2.6-closed"])
                           if "workloads" in m and "fig6-a4.9-closed"
                           in m["workloads"] else m
                           for m in BENCH["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = core.resolve("fig6-a2.6-closed", repo=tmp_path)
    assert cell.mix["rate_hz"] == 1_800_000.0
    assert cell.driver.__file__.startswith(str(tmp_path))
    assert "realtime_streams" in {m["name"] for m in cell.end_to_end}
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data
