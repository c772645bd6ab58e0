"""Atomic step checkpoints of tensor trees, counterpart of
``repro.train.checkpoint``.

Layout:  <dir>/step_<N>/
             manifest.json        — step, leaf paths, shapes, dtypes, extras
             <leaf-path>.npy      — one file per leaf (the whole array)

* **atomic** — written to ``step_<N>.tmp`` then ``os.rename``d; a crash
  mid-save never corrupts the latest checkpoint; :func:`latest` only sees
  fully renamed directories.
* **keep-last-k** — old steps are deleted after a successful save.
* the data cursor and step counter ride in the manifest's ``extras``, so a
  restart resumes without replaying data.

A tree is any nesting of dicts, tuples, lists and NamedTuples with tensor
leaves; a leaf's name is its path (``1/mu/0``, ``0/layers/3/attn/wq``), as
the reference names pytree paths (dict keys sorted, as JAX flattens
them).  A bfloat16 leaf is stored as its 16-bit pattern (numpy has no
bfloat16) with ``"bfloat16"`` in the manifest, and restored bitwise.
:func:`restore` puts each leaf on the device and dtype of the matching
leaf of its target.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _children(tree: Any) -> List[Tuple[Any, Any]]:
    """``(key, child)`` pairs of a container: a dict's in sorted key order,
    a NamedTuple's by field name, a tuple's or list's by index."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    return list(enumerate(tree))


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, leaf)`` pairs in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    out = []
    for k, v in _children(tree):
        out += _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _unflatten(tree: Any, leaves) -> Any:
    """``tree``'s structure with its leaves taken in :func:`_flatten`'s
    order from the iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        new = {k: _unflatten(v, leaves) for k, v in _children(tree)}
        return {k: new[k] for k in tree}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, leaves) for v in tree))
    return type(tree)(_unflatten(v, leaves) for v in tree)


def _to_numpy(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """The array stored for ``leaf`` and the dtype the manifest names."""
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy(), "bfloat16"
    arr = leaf.numpy()
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Any,
         extras: Optional[Dict[str, Any]] = None,
         keep_last: int = 3) -> str:
    """Atomically save ``tree`` at ``step``.  Returns the final directory."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "extras": extras or {}}
    for name, leaf in _flatten(tree):
        arr, dtype = _to_numpy(leaf)
        fn = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append(
            {"name": name, "file": fn, "shape": list(arr.shape),
             "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest(ckpt_dir: str) -> Optional[int]:
    """The newest complete step in ``ckpt_dir``, or ``None``."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, target: Any
            ) -> Tuple[Any, Dict[str, Any]]:
    """Load ``step`` into the structure of ``target``; returns ``(tree,
    extras)``.  Every leaf must be in the checkpoint with the target's
    shape."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {l["name"]: l for l in manifest["leaves"]}
    out = []
    for name, tgt in _flatten(target):
        meta = by_name.get(name)
        if meta is None:
            raise KeyError(f"checkpoint {d} missing leaf {name!r}")
        arr = np.load(os.path.join(d, meta["file"]))
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"{name}: checkpoint shape {arr.shape} != "
                             f"target {tuple(tgt.shape)}")
        t = torch.from_numpy(arr)
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        out.append(t.to(device=tgt.device, dtype=tgt.dtype))
    return _unflatten(target, iter(out)), manifest["extras"]
