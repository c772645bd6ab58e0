"""Collectives over shard lists, with the semantics of JAX's tiled
collectives inside ``shard_map`` (the port's counterpart of the
reference's ``jax.lax`` collectives and its ``shard_map`` in- and
out-specs).

A sharded value is a list of per-shard tensors, one per mesh coordinate in
shard order (`distributed.mesh.Mesh`), each on its shard's device.

* :func:`split` / :func:`join` move between a global tensor and its shard
  list under a partition spec (one entry per dimension: None, an axis
  name, or a tuple of axis names folded in order).  A mesh axis that the
  spec does not name replicates the tensor; :func:`join` takes coordinate
  0's copy along it.
* :func:`psum` / :func:`pmax` / :func:`pmean` reduce over one axis or a
  tuple of axes: for each group of shards that differ only on those axes,
  in increasing coordinate order, on the group's first device; the result
  is then copied to each member's device.  The order is fixed, so a run
  repeats bitwise.
* :func:`all_gather` concatenates a group's tensors in coordinate order;
  :func:`all_to_all` sends chunk ``i`` of shard ``j`` to position ``j`` of
  shard ``i``.

Everything is built from slicing, ``.to(device)``, ``cat`` and adds, so
autograd runs through it.

While :func:`counting` is open, each of the five collectives adds one row
to the list it yields: the reference's HLO kind (``"all-reduce"`` for
``psum`` / ``pmax`` / ``pmean``, ``"all-gather"``, ``"all-to-all"``), a
count of 1, the payload bytes per device (one shard's result), the wire
bytes per device by the reference's ring model (all-reduce
``2 (g - 1) / g`` of the payload, all-gather and all-to-all
``(g - 1) / g``, for a group of ``g`` shards), and the calling function as
``op_name``.  Outside it they do exactly what they do without it.
"""
from __future__ import annotations

import contextlib
import math
import sys
from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

from repro_torch.distributed.mesh import Mesh

Parts = List[torch.Tensor]
Axes = Union[str, Sequence[str]]


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


_ROWS: Dict[str, list] = {"rows": None}

# the reference's per-kind ring model (``repro.launch.dryrun``): wire bytes
# per device over payload bytes per device, for a group of g
WIRE = {"all-reduce": lambda g: 2.0 * (g - 1) / g,
        "all-gather": lambda g: (g - 1) / g,
        "all-to-all": lambda g: (g - 1) / g}


@contextlib.contextmanager
def counting():
    """Yield a list that receives one row for every collective issued
    while the block is open (nested blocks each see their own)."""
    prev, rows = _ROWS["rows"], []
    _ROWS["rows"] = rows
    try:
        yield rows
    finally:
        _ROWS["rows"] = prev


def _record(kind: str, result: torch.Tensor, axes: Axes,
            mesh: Mesh) -> None:
    rows = _ROWS["rows"]
    if rows is None:
        return
    g = math.prod(mesh.shape[a] for a in _axes(axes))
    nbytes = result.numel() * result.element_size()
    rows.append({"kind": kind, "count": 1, "bytes": nbytes,
                 "wire_bytes": nbytes * WIRE[kind](g), "group": g,
                 "op_name": sys._getframe(2).f_code.co_name,
                 "source": "issued"})


def axis_index(mesh: Mesh, axes: Axes, shard: int) -> int:
    """Shard ``shard``'s index along ``axes``: its coordinates on them,
    folded in order (``i = i * size(a) + coord(a)``)."""
    c, i = mesh.coords(shard), 0
    for a in _axes(axes):
        i = i * mesh.shape[a] + c[a]
    return i


def _spec_of(spec, ndim: int, mesh: Mesh) -> List[Tuple[str, ...]]:
    spec = [_axes(e) for e in spec]
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    used = [a for e in spec for a in e]
    if len(used) != len(set(used)) or not set(used) <= set(mesh.shape):
        raise ValueError(f"spec {spec} names an axis twice or one that "
                         f"{mesh} lacks")
    return spec + [()] * (ndim - len(spec))


def split(x: torch.Tensor, spec, mesh: Mesh) -> Parts:
    """``x``'s tile for every shard, on that shard's device: dimension
    ``d`` is cut into ``prod(sizes of spec[d])`` equal tiles, shard ``s``
    taking the tile at its index along those axes."""
    spec = _spec_of(spec, x.dim(), mesh)
    parts = []
    for s in range(mesh.size):
        t = x
        for dim, axes in enumerate(spec):
            if axes:
                n = math.prod(mesh.shape[a] for a in axes)
                if x.shape[dim] % n:
                    raise ValueError(f"dim {dim} of {tuple(x.shape)} does "
                                     f"not divide over {axes} ({n})")
                size = x.shape[dim] // n
                t = t.narrow(dim, axis_index(mesh, axes, s) * size, size)
        parts.append(t.to(mesh.devices[s]))
    return parts


def join(parts: Parts, spec, mesh: Mesh) -> torch.Tensor:
    """The global tensor whose :func:`split` is ``parts``, on shard 0's
    device; along an axis the spec does not name, coordinate 0's copy."""
    spec = _spec_of(spec, parts[0].dim(), mesh)
    dev = mesh.devices[0]
    named = {a for axes in spec for a in axes}
    if not named:
        return parts[0].to(dev)
    local = parts[0].shape
    shape = [local[d] * math.prod(mesh.shape[a] for a in axes)
             for d, axes in enumerate(spec)]
    out = parts[0].new_empty(shape, device=dev)
    for s in range(mesh.size):
        c = mesh.coords(s)
        if any(c[a] for a in mesh.axis_names if a not in named):
            continue
        idx = tuple(slice(axis_index(mesh, axes, s) * local[d],
                          (axis_index(mesh, axes, s) + 1) * local[d])
                    for d, axes in enumerate(spec))
        out[idx] = parts[s].to(dev)
    return out


def groups(mesh: Mesh, axes: Axes) -> List[List[int]]:
    """The shards that differ only on ``axes``, one list per group, each
    in increasing index along ``axes``."""
    axes = _axes(axes)
    rest = [a for a in mesh.axis_names if a not in axes]
    out: Dict[Tuple[int, ...], List[int]] = {}
    for s in range(mesh.size):
        c = mesh.coords(s)
        out.setdefault(tuple(c[a] for a in rest), []).append(s)
    return [sorted(g, key=lambda s: axis_index(mesh, axes, s))
            for g in out.values()]


def _reduce(parts: Parts, axes: Axes, mesh: Mesh,
            op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
            ) -> Parts:
    out: Parts = [None] * mesh.size
    for g in groups(mesh, axes):
        dev = mesh.devices[g[0]]
        acc = parts[g[0]].to(dev)
        for s in g[1:]:
            acc = op(acc, parts[s].to(dev))
        for s in g:
            out[s] = acc.to(mesh.devices[s])
    return out


def psum(parts: Parts, axes: Axes, mesh: Mesh) -> Parts:
    """The sum over ``axes`` (``jax.lax.psum``)."""
    _record("all-reduce", parts[0], axes, mesh)
    return _reduce(parts, axes, mesh, torch.add)


def pmax(parts: Parts, axes: Axes, mesh: Mesh) -> Parts:
    """The elementwise maximum over ``axes`` (``jax.lax.pmax``)."""
    _record("all-reduce", parts[0], axes, mesh)
    return _reduce(parts, axes, mesh, torch.maximum)


def pmean(parts: Parts, axes: Axes, mesh: Mesh) -> Parts:
    """The mean over ``axes``: the sum over the group's size
    (``jax.lax.pmean``)."""
    _record("all-reduce", parts[0], axes, mesh)
    n = math.prod(mesh.shape[a] for a in _axes(axes))
    return [p / n for p in _reduce(parts, axes, mesh, torch.add)]


def all_gather(parts: Parts, axis: Axes, dim: int, mesh: Mesh) -> Parts:
    """Each shard gets its group's tensors concatenated along ``dim`` in
    coordinate order (``jax.lax.all_gather(..., tiled=True)``).  Shards of
    a group on one device share one result."""
    out: Parts = [None] * mesh.size
    for g in groups(mesh, axis):
        made: Dict[torch.device, torch.Tensor] = {}
        for s in g:
            dev = mesh.devices[s]
            if dev not in made:
                made[dev] = torch.cat([parts[m].to(dev) for m in g], dim)
            out[s] = made[dev]
    _record("all-gather", out[0], axis, mesh)
    return out


def all_to_all(parts: Parts, axis: Axes, split_dim: int, concat_dim: int,
               mesh: Mesh) -> Parts:
    """Each shard cuts its tensor into as many chunks along ``split_dim``
    as its group has members; member ``i`` receives chunk ``i`` of every
    member ``j``, concatenated along ``concat_dim`` in ``j`` order
    (``jax.lax.all_to_all(..., tiled=True)``)."""
    out: Parts = [None] * mesh.size
    for g in groups(mesh, axis):
        k = len(g)
        if parts[g[0]].shape[split_dim] % k:
            raise ValueError(f"dim {split_dim} of "
                             f"{tuple(parts[g[0]].shape)} does not split "
                             f"into {k}")
        size = parts[g[0]].shape[split_dim] // k
        chunks = {m: parts[m].split(size, split_dim) for m in g}
        for i, s in enumerate(g):
            out[s] = torch.cat([chunks[m][i].to(mesh.devices[s]) for m in g],
                               concat_dim)
    _record("all-to-all", out[0], axis, mesh)
    return out
