"""The paper's own configuration: the SNE engine and the Fig. 6 eCNN
(counterpart of ``repro.configs.sne_dvsgesture``).

Not one of the ten LM architectures: the paper's native workload
(IBM-DVS-Gesture / NMNIST event-based CNN on the 8-slice SNE engine),
behind the same ``config()`` entry point as the LM registry.
"""
from repro_torch.core.engine import SneConfig
from repro_torch.core.sne_net import (SNNSpec, dvs_gesture_net, nmnist_net,
                                      tiny_net)


def config() -> SNNSpec:
    return dvs_gesture_net()


def nmnist() -> SNNSpec:
    return nmnist_net()


def smoke() -> SNNSpec:
    return tiny_net()


def engine(n_slices: int = 8) -> SneConfig:
    return SneConfig(n_slices=n_slices)
