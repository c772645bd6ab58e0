"""Device placement: the slot axis of the mesh serving backend, and the
logical-axis rules of the LM stack (counterpart of
``repro.distributed.sharding``).

**Slot-axis helpers (mesh serving).**  The reference builds a 1-D JAX mesh
over the slot axis and runs one ``shard_map``-ped step over it; the port
has no such collective, so its "mesh" is the ordered tuple of devices that
hold the slot shards, shard ``s`` owning global slots ``[s * n / D,
(s + 1) * n / D)``.  A device may repeat: ``["cpu", "cpu"]`` or
``["cuda:0", "cuda:0"]`` puts several shards on one device, which
exercises the router and both dispatch paths where only one device exists.

**Logical-axis rules (the LM stack).**  A :class:`MeshRules` table maps
logical axis names ("batch", "p_embed", "p_experts", ...) to mesh axes;
:meth:`MeshRules.spec` resolves a tensor's axes to a
:class:`PartitionSpec`, dropping a mapping whose size does not divide the
dimension (down to its largest divisible prefix) and any mesh axis that an
earlier dimension of the same tensor took.  :func:`default_rules` is the
reference's table, entry for entry.  :func:`set_mesh_rules` installs a
process-global mesh (`distributed.mesh.Mesh`) and table; the LM paths that
read it (`models.transformer`'s MoE dispatch, `core.sd_decode`) take their
sharded forms under it.  :func:`logical` resolves a spec and returns its
tensor unchanged: values do not depend on the layout, and the port's
layout is its shard lists (`distributed.collectives`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.device import resolve_device

Devices = Union[None, int, Sequence[Union[str, torch.device]]]


def visible_cards() -> int:
    """The number of CUDA cards this process sees; raise without one (as
    every entry point of the port does)."""
    resolve_device("cuda")
    return torch.cuda.device_count()


def slot_mesh(devices: Devices = None) -> Tuple[torch.device, ...]:
    """The devices of the slot shards, in shard order.

    ``devices`` is a sequence of devices (repeats allowed), a count (the
    first ``n`` visible cards), or None for every visible card.  Each
    device is resolved by `repro_torch.device.resolve_device`, so asking
    for CUDA on a machine without a card raises.
    """
    if devices is None:
        devices = visible_cards()
    if isinstance(devices, int):
        if devices < 1:
            raise ValueError(f"need at least 1 device, got {devices}")
        n = visible_cards()
        if devices > n:
            raise ValueError(f"requested {devices} devices, only {n} "
                             f"visible")
        return tuple(torch.device("cuda", i) for i in range(devices))
    devs = tuple(resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("need at least 1 device, got an empty sequence")
    return devs


def shard_count(n_slots: int, n_visible: int) -> int:
    """The auto-pick rule of ``devices=None``: the largest divisor of
    ``n_slots`` that is at most ``min(n_visible, n_slots)``, so that the
    slots divide into equal shards whatever the slot count."""
    if n_slots < 1 or n_visible < 1:
        raise ValueError(f"need n_slots >= 1 and n_visible >= 1, got "
                         f"{n_slots} and {n_visible}")
    d = min(n_visible, n_slots)
    while n_slots % d:
        d -= 1
    return d


# ---------------------------------------------------------------------------
# Logical-axis rules: the LM stack
# ---------------------------------------------------------------------------

Axis = Union[str, Tuple[str, ...], None]


class PartitionSpec(tuple):
    """One entry per dimension (None, a mesh axis, or a tuple of mesh
    axes); equal to the tuple of its entries, as JAX's is."""

    def __new__(cls, *entries: Axis):
        return super().__new__(cls, entries)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Logical-axis -> mesh axis mapping."""

    rules: Tuple[Tuple[str, Axis], ...]

    def get(self, name: Optional[str]) -> Axis:
        """The mesh axis of one logical name (None: replicated)."""
        if name is None:
            return None
        for k, v in self.rules:
            if k == name:
                return v
        return None

    def spec(self, axes: Sequence[Optional[str]], shape: Sequence[int],
             mesh) -> PartitionSpec:
        """Resolve logical axes to a spec on ``mesh`` (anything with a
        ``shape`` dict of axis sizes): a mapping that does not divide its
        dimension falls back to its largest divisible prefix or to
        replication, and a mesh axis is used at most once per tensor."""
        out = []
        used: set = set()
        for name, dim in zip(axes, shape):
            phys = self.get(name)
            if phys is None:
                out.append(None)
                continue
            phys_t = (phys,) if isinstance(phys, str) else tuple(phys)
            phys_t = tuple(a for a in phys_t if a not in used)
            while phys_t and dim % math.prod(
                    mesh.shape[a] for a in phys_t) != 0:
                phys_t = phys_t[:-1]
            if not phys_t:
                out.append(None)
                continue
            used.update(phys_t)
            out.append(phys_t[0] if len(phys_t) == 1 else phys_t)
        return PartitionSpec(*out)


def default_rules(multi_pod: bool, long_context: bool = False,
                  seq_shard: bool = False, serve: bool = False) -> MeshRules:
    """The reference's production table (``repro.distributed.sharding.
    default_rules``): DP on "batch", FSDP of every weight's d_model over
    "data" (not under ``serve``), Megatron TP and EP over "model" (TP off
    under ``seq_shard``, which shards "seq" over "model" instead), and the
    decode KV length over "model" ("data" too under ``long_context``)."""
    batch: Axis = ("pod", "data") if multi_pod else ("data",)
    kv_seq: Axis = ("data", "model") if long_context else ("model",)
    tp: Axis = None if seq_shard else "model"
    p_embed: Axis = None if serve else "data"
    return MeshRules(rules=(
        # activations
        ("batch", batch),
        ("seq", "model" if seq_shard else None),
        ("act_embed", None),
        ("act_mlp", tp),
        ("act_heads", tp),
        ("act_kv_heads", tp),
        ("act_vocab", tp),
        # use-time weight constraints
        ("use_mlp", tp),
        ("use_heads", tp),
        ("use_kv", tp),
        ("use_vocab", tp),
        ("use_embed", None if seq_shard else p_embed),
        ("kv_seq", kv_seq),
        ("kv_window", kv_seq),
        # parameters
        ("p_embed", p_embed),
        ("p_mlp", "model"),
        ("p_heads", "model"),
        ("p_kv_heads", "model"),
        ("p_vocab", "model"),
        ("p_experts", "model"),
        ("p_layers", None),
        ("p_state", None),
    ))


_CTX: dict = {"rules": None, "mesh": None}


def set_mesh_rules(mesh, rules: MeshRules) -> None:
    """Install the process-global mesh and rule table."""
    _CTX["mesh"] = mesh
    _CTX["rules"] = rules


def clear_mesh_rules() -> None:
    """Remove the global mesh and rules (single-device runs, teardown)."""
    _CTX["mesh"] = None
    _CTX["rules"] = None


def current_mesh():
    """The installed mesh, or None."""
    return _CTX["mesh"]


def logical(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """``x`` itself; with a mesh and rules installed its spec is resolved
    first (so a rule that cannot apply raises as the reference's does)."""
    mesh, rules = _CTX["mesh"], _CTX["rules"]
    if mesh is not None and rules is not None:
        rules.spec(axes, x.shape, mesh)
    return x
