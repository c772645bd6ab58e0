"""Small configurations and mixes for the benchmark's CPU tests: the
cells' own files with the geometry cut to a 12x12 sensor."""
import json

import torch

from perfbench.core import BENCH_DIR, RunContext

LAYERS = [
    {"kind": "conv", "out_channels": 6, "kernel": 3, "stride": 1,
     "padding": 1, "threshold": 1.0, "leak": 0.03125},
    {"kind": "pool", "out_channels": 6, "kernel": 2, "stride": 2,
     "padding": 0, "threshold": 0.999, "leak": 0.03125},
    {"kind": "fc", "out_channels": 4, "kernel": 3, "stride": 1,
     "padding": 0, "threshold": 1.0, "leak": 0.03125}]


def load(kind: str, name: str) -> dict:
    return json.loads((BENCH_DIR / kind / f"{name}.json").read_text())


def config(n_timesteps: int = 16) -> dict:
    """``tiny_net()``'s geometry in a configuration file's form."""
    return dict(load("configs", "fig6-dvsgesture"), input=[12, 12, 2],
                sensor=[12, 12], n_timesteps=n_timesteps, n_classes=4,
                layers=LAYERS)


def serve_mix() -> dict:
    return dict(load("traffic", "closed-a4.9"), slots=8, clients=16,
                rate_hz=40_000.0, pool=6)


def train_mix() -> dict:
    mix = load("traffic", "train-b128")
    return dict(mix, batch=4, data=dict(
        mix["data"], n_classes=4, height=12, width=12, n_timesteps=8,
        base_activity=0.06, n_blobs=1))


def ctx(config, mix, seed=2 ** 33 + 7, seconds=0.3, runtime_clock=None):
    """A driver's context on the CPU."""
    return RunContext(config=config, mix=mix, seed=seed, seconds=seconds,
                      trace=False, device=torch.device("cpu"),
                      runtime_clock=runtime_clock)
