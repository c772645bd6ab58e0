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

A tree is any nesting of tuples, lists and NamedTuples with tensor
leaves; a leaf's name is its path (``1/mu/0``), as the reference names
pytree paths.  :func:`restore` puts each leaf on the device and dtype of
the matching leaf of its target.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, leaf)`` pairs in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = (zip(tree._fields, tree) if hasattr(tree, "_fields")
             else enumerate(tree))
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def _unflatten(tree: Any, leaves) -> Any:
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, leaves) for v in tree))
    return type(tree)(_unflatten(v, leaves) for v in tree)


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
        arr = leaf.detach().cpu().numpy()
        fn = name.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append(
            {"name": name, "file": fn, "shape": list(arr.shape),
             "dtype": str(arr.dtype)})
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
        out.append(torch.from_numpy(arr).to(device=tgt.device,
                                            dtype=tgt.dtype))
    return _unflatten(target, iter(out)), manifest["extras"]
