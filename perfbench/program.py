"""The port's side of an eCNN configuration: its ``SNNSpec`` and execution
policy built from the configuration's file, and the host spans around the
calls into each of its layers.  Imports the port only inside functions, so
that the harness loads without it."""
from __future__ import annotations


def snn_spec(config: dict):
    """The configuration's network as the port's ``SNNSpec``."""
    from repro_torch.core.econv import EConvSpec
    from repro_torch.core.lif import LifParams
    from repro_torch.core.sne_net import SNNSpec
    shape, layers = tuple(config["input"]), []
    for l in config["layers"]:
        spec = EConvSpec(l["kind"], shape, l["out_channels"],
                         kernel=l["kernel"], stride=l["stride"],
                         padding=l["padding"],
                         lif=LifParams(threshold=l["threshold"],
                                       leak=l["leak"]))
        layers.append(spec)
        shape = spec.out_shape
    return SNNSpec(layers=tuple(layers), n_timesteps=config["n_timesteps"],
                   n_classes=config["n_classes"])


def serving_policy(config: dict):
    """The ``ExecutionPolicy`` the configuration serves under."""
    from repro_torch.core.policies import ExecutionPolicy
    s = config["serving"]
    return ExecutionPolicy(dtype_policy=s["dtype_policy"],
                           fusion_policy=s["fusion_policy"],
                           idle_skip=s["idle_skip"],
                           tile_sparsity=s["tile_sparsity"])
