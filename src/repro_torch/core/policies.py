"""Execution policies for the layer-program executor (single source).

Counterpart of ``repro.core.policies``: the same three axes, the same names
and the same default, validated where the policy is written.

* **dtype policy** — ``"f32-carrier"`` (integers held in float32; the
  exactness oracle) or ``"int8-native"`` (int8 codes and storage, int32
  accumulation).
* **fusion policy** — ``"per-step"`` (one scatter launch per layer per
  timestep; the bitwise oracle), ``"fused-window"`` (one launch per layer
  per window) or ``"fused-network"`` (one launch per window).
* **backend** — ``"local"`` (one device) or ``"mesh"`` (the slot axis
  sharded over several devices, `serve.mesh_engine`).

Plus the serving-time toggles ``idle_skip`` and ``tile_sparsity``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

F32_CARRIER = "f32-carrier"
INT8_NATIVE = "int8-native"
DTYPE_POLICIES = (F32_CARRIER, INT8_NATIVE)

PER_STEP = "per-step"
FUSED_WINDOW = "fused-window"
FUSED_NETWORK = "fused-network"
FUSION_POLICIES = (PER_STEP, FUSED_WINDOW, FUSED_NETWORK)

BACKEND_LOCAL = "local"
BACKEND_MESH = "mesh"
BACKENDS = (BACKEND_LOCAL, BACKEND_MESH)


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    """One frozen value naming every execution-policy axis.

    Defaults match the reference's production configuration (float32
    carrier, fused windows, idle skip on, local backend).
    """

    dtype_policy: str = F32_CARRIER
    fusion_policy: str = FUSED_WINDOW
    idle_skip: bool = True
    backend: str = BACKEND_LOCAL
    tile_sparsity: bool = True

    def __post_init__(self):
        """Validate every axis name — fail where the policy is written."""
        if self.dtype_policy not in DTYPE_POLICIES:
            raise ValueError(f"unknown dtype policy {self.dtype_policy!r} "
                             f"(expected one of {DTYPE_POLICIES})")
        if self.fusion_policy not in FUSION_POLICIES:
            raise ValueError(f"unknown fusion policy {self.fusion_policy!r} "
                             f"(expected one of {FUSION_POLICIES})")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r} "
                             f"(expected one of {BACKENDS})")
        if not isinstance(self.idle_skip, bool):
            raise ValueError(f"idle_skip must be a bool, "
                             f"got {self.idle_skip!r}")
        if not isinstance(self.tile_sparsity, bool):
            raise ValueError(f"tile_sparsity must be a bool, "
                             f"got {self.tile_sparsity!r}")

    def __str__(self):
        """Compact ``dtype/fusion/backend`` label (stable pytest ids)."""
        tag = "" if self.idle_skip else "/no-idle-skip"
        tag += "" if self.tile_sparsity else "/no-tile-sparsity"
        return (f"{self.dtype_policy}/{self.fusion_policy}/"
                f"{self.backend}{tag}")


def all_policies(backends: Tuple[str, ...] = BACKENDS,
                 idle_skip: bool = True) -> Tuple[ExecutionPolicy, ...]:
    """Enumerate the dtype × fusion × backend matrix (backend-major, then
    dtype, then fusion — the reference's order)."""
    return tuple(ExecutionPolicy(dtype_policy=d, fusion_policy=f,
                                 idle_skip=idle_skip, backend=b)
                 for b in backends
                 for d in DTYPE_POLICIES
                 for f in FUSION_POLICIES)
