"""Multi-pod dry-run: run every (architecture x input shape x mesh) cell's
step on ``meta`` tensors at the cell's global shapes, under the
production mesh's rules, and count what it does (counterpart of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--single-pod-only]

Nothing is allocated on any device: parameters, optimizer state, caches
and the batch are storage-free ``meta`` tensors built from the logical-axis
declarations (`launch.specs`), and the step is the port's own code
(``make_train_step``, ``prefill``, ``decode_step``).  The reference lowers
and compiles the step with XLA and reads the compiled artifact; there is
no HLO here, so the record holds what the port can count instead:

* ``flops_global``: ``torch.utils.flop_counter.FlopCounterMode`` over one
  run of the step (every matmul, batched matmul and convolution; the
  layer, attention-chunk and loss-chunk loops are Python loops, so every
  iteration is seen), plus ``_recurrence_flops`` for the xLSTM sequence
  loop, whose body runs once under the analysis switch
  (`models.scan_util`); ``flops_per_device`` is it over the device count;
* ``bytes_global_unfused``: the input plus output bytes of every aten op
  that is not a view, as one dispatch mode sees them;
* ``peak_live_bytes_global``: the most bytes of live tensor storage at any
  point of the step (its inputs included), in place of XLA's
  ``memory_analysis``;
* ``state_bytes_per_device``: the reference's ``_analytic_state_bytes`` on
  the stand-ins' partition specs;
* ``collectives``: the reference's per-kind dict (count, payload bytes and
  ring wire bytes per device) plus ``total_bytes`` and
  ``total_wire_bytes``, summed over ``rows``: one row for each collective
  that `distributed.collectives` issued (``"source": "issued"``: the
  shard-map MoE, the sharded sigma-delta matvec, the flash-decode combine)
  and the rows of :func:`modelled_collectives` (``"source": "model"``),
  the collectives the reference's SPMD partitioner inserts for the dense
  path and the port does not issue;
* ``run_s``, the wall time of the meta run, in place of ``lower_s`` and
  ``compile_s``.

The reference's ``bytes_per_device`` and ``cost`` (XLA's cost analysis of
the partitioned program), ``memory_analysis`` (of the compiled buffers)
and ``parse_s`` (of the HLO text) have no counterpart: the port has no
partitioned program, no compiled buffer assignment and no HLO.  A failing
cell raises, as in the reference.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import weakref
from typing import Any, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeSpec, cell_supported,
                                 get_config)
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import (clear_mesh_rules,
                                              default_rules, set_mesh_rules)
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import config as MC
from repro_torch.models import transformer as T
from repro_torch.models.layers import tree_leaves
from repro_torch.models.moe import _capacity
from repro_torch.models.quant_lm import dequant_params
from repro_torch.models.scan_util import analysis
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.loop import make_train_step

COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute")
# reduce-scatter's ring model in the reference: (g - 1) x the result piece
WIRE = dict(col.WIRE, **{"reduce-scatter": lambda g: float(g - 1)})


def _recurrence_flops(cfg, kind: str, B: int, S: int) -> float:
    """Analytic FLOPs of per-timestep recurrences (xLSTM cells).

    The sequence scan is exempt from analysis unrolling (a 32k-step
    recurrence cannot be inlined into the IR), so its body cost is added
    here: mLSTM ~7 elementwise/outer-product passes over the (H, hd, hd)
    matrix memory per step; sLSTM 4 recurrent (hd x hd) matvecs per step.
    Train counts fwd + remat-fwd + 2x bwd = 4x; prefill 1x; decode steps
    are inline in the IR (no seq scan) and already counted.
    """
    if kind == "decode":
        return 0.0
    fl = 0.0
    for spec in cfg.layers:
        if spec.mixer == MC.MLSTM:
            di = 2 * cfg.d_model
            hd = di // cfg.n_heads
            fl += 7.0 * B * cfg.n_heads * hd * hd * S
        elif spec.mixer == MC.SLSTM:
            hd = cfg.d_model // cfg.n_heads
            fl += 2.0 * 4.0 * B * cfg.n_heads * hd * hd * S
    factor = (4.0 if cfg.remat else 3.0) if kind == "train" else 1.0
    return fl * factor


def build_step_fn(cfg, shape, mesh, rules, device="meta",
                  loss_chunk: int = 512,
                  gen: Optional[torch.Generator] = None):
    """``(fn, args, state_specs)`` for one cell's step kind: ``fn(*args)``
    runs the step on ``args``, the stand-ins made into tensors on
    ``device`` (``meta``: no storage; elsewhere parameters drawn from
    ``gen``, seeded 0 on ``device`` if None); ``state_specs`` is the
    tuple of stand-in trees whose bytes per device the cell reports (the
    reference's: params and optimizer state, params, or params and
    caches)."""
    dev = torch.device(device)
    if dev.type != "meta" and gen is None:
        gen = torch.Generator(dev).manual_seed(0)
    bspecs = SP.batch_specs(cfg, shape, mesh, rules)
    quant = shape.kind == "decode" and cfg.weight_quant == "int8"
    pspecs = SP.param_specs(cfg, mesh, rules, quantized=quant)
    params = SP.materialize(pspecs, dev, gen)
    batch = SP.materialize(bspecs, dev, gen)

    if shape.kind == "train":
        ospecs = SP.opt_specs(cfg, mesh, rules)
        step = make_train_step(cfg, warmup_cosine(3e-4, 100, 10_000),
                               loss_chunk=loss_chunk)
        return (step, (params, SP.materialize(ospecs, dev, gen), batch),
                (pspecs, ospecs))
    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            return T.prefill(params, cfg, batch["tokens"],
                             frames=batch.get("frames"),
                             patches=batch.get("patches"),
                             cache_len=shape.seq_len)
        return prefill_fn, (params, batch), (pspecs,)

    cspecs = SP.cache_specs(cfg, mesh, rules, shape.global_batch,
                            shape.seq_len)

    def decode_fn(params, cache, batch):
        if quant:
            params = dequant_params(params, cfg.tdtype)
        return T.decode_step(params, cfg, cache, batch["tokens"],
                             batch["pos"])
    return (decode_fn, (params, SP.materialize(cspecs, dev, gen), batch),
            (pspecs, cspecs))


# ---------------------------------------------------------------------------
# Counting one run of a step
# ---------------------------------------------------------------------------

def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Accounting(TorchDispatchMode):
    """Sums the input and output bytes of every aten op that is not a view
    (``bytes``) and follows the bytes of live tensor storage: a storage
    counts from the first op output that holds it until the last tensor
    on it that this mode saw dies (``live``, ``peak``); the storages of
    ``pinned`` tensors count throughout."""

    def __init__(self, pinned: List[torch.Tensor]):
        super().__init__()
        self.bytes = 0
        self._refs: Dict[int, List[int]] = {}   # storage -> [nbytes, refs]
        self._pinned = set()
        self.live = 0
        for t in pinned:
            k = _key(t)
            if k not in self._pinned:
                self._pinned.add(k)
                self.live += t.untyped_storage().nbytes()
        self.peak = self.live

    def _release(self, k: int) -> None:
        ent = self._refs[k]
        ent[1] -= 1
        if ent[1] == 0:
            self.live -= ent[0]
            del self._refs[k]

    def _track(self, t: torch.Tensor) -> None:
        k = _key(t)
        if k in self._pinned:
            return
        ent = self._refs.get(k)
        if ent is None:
            ent = self._refs[k] = [t.untyped_storage().nbytes(), 0]
            self.live += ent[0]
            self.peak = max(self.peak, self.live)
        ent[1] += 1
        weakref.finalize(t, self._release, k)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = _tensors(out)
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in _tensors(args) + _tensors(kwargs)
                              + outs)
        for t in outs:
            self._track(t)
        return out


def measure(fn, args) -> Dict[str, Any]:
    """Run ``fn(*args)`` once under the analysis switch and count it: its
    matmul FLOPs in total and by aten op (``FlopCounterMode``), its
    unfused bytes and peak live bytes, the collectives it issued, and its
    wall time."""
    t0 = time.perf_counter()
    with analysis(), col.counting() as rows, \
            FlopCounterMode(display=False) as fc, \
            _Accounting(_tensors(args)) as acc:
        out = fn(*args)
        del out
    run_s = time.perf_counter() - t0
    by_op = {str(k): int(v) for k, v in
             fc.get_flop_counts().get("Global", {}).items()}
    return {"flops": int(fc.get_total_flops()), "flops_by_op": by_op,
            "bytes_unfused": float(acc.bytes),
            "peak_live_bytes": float(acc.peak), "issued": rows,
            "run_s": run_s}


# ---------------------------------------------------------------------------
# The collectives the reference's partitioner inserts on the dense path
# ---------------------------------------------------------------------------

def _axes_of(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _row(kind: str, count: int, nbytes: float, g: int, op_name: str):
    return {"kind": kind, "count": count, "bytes": float(nbytes),
            "wire_bytes": float(nbytes) * WIRE[kind](g), "group": g,
            "op_name": op_name, "source": "model"}


def modelled_collectives(cfg, shape, mesh, rules) -> List[Dict[str, Any]]:
    """The collectives of one cell that the reference's SPMD partitioner
    inserts and the port's dense path does not issue, one row per weight
    (``count`` uses of ``bytes`` payload per device each):

    * an FSDP all-gather over "data" of every weight stored sharded over
      it, once per pass that uses it (forward; in a train cell also the
      backward, and the remat forward under ``cfg.remat``);
    * in a train cell, each gradient's reduction over the batch axes: a
      reduce-scatter over "data" for a weight sharded over it (then an
      all-reduce of the piece over "pod" on the multi-pod mesh), an
      all-reduce over the batch axes for one that is not;
    * Megatron's all-reduce over "model" of the (B / dp, S, d_model)
      activation after every row-parallel projection whose input axis is
      model-sharded (attention output, FFN and block down projections),
      once per pass, while tensor parallelism is on (not under
      ``seq_shard``);
    * the expert dispatch and combine all-to-alls over "model" of each MoE
      layer's (E, C, d) buffer with ``moe_impl="gather"``, twice per pass.

    The issued paths (the shard-map MoE, the sharded sigma-delta decode)
    are counted where they run and get no modelled row.  Decode runs
    neither the encoder nor the frontend."""
    kind = shape.kind
    passes = (2 + int(cfg.remat)) if kind == "train" else 1
    quant = kind == "decode" and cfg.weight_quant == "int8"
    pspecs = SP.param_specs(cfg, mesh, rules, quantized=quant)
    B, S = shape.global_batch, shape.seq_len
    batch_spec = rules.spec(("batch",), (B,), mesh)
    dp = math.prod(mesh.shape[a] for a in _axes_of(batch_spec[0]))
    batch_axes = [a for a in _axes_of(rules.get("batch")) if a in mesh.shape]
    item = cfg.tdtype.itemsize
    tp = rules.get("act_mlp") is not None and "model" in mesh.shape
    sd = kind == "decode" and cfg.sd_decode_frac > 0
    rows: List[Dict[str, Any]] = []
    for path, s in tree_leaves(pspecs):
        name = ".".join(str(p) for p in path)
        if kind == "decode" and path[0] in ("encoder", "frontend"):
            continue
        layer = (cfg.layers[path[1]] if path[0] == "layers" else None)
        if sd and layer is not None and layer.mixer == MC.RGLRU and \
                path[2] in ("rglru", "ffn"):
            continue                       # the sharded sd matvec's weights
        spec = [_axes_of(e) for e in s.spec]
        piece = s.nbytes() / s.shards()
        if any("data" in e for e in spec):
            g = mesh.shape["data"]
            rows.append(_row("all-gather", passes, piece * g, g,
                             f"fsdp_gather:{name}"))
            if kind == "train":
                rows.append(_row("reduce-scatter", 1, piece, g,
                                 f"grad_reduce_scatter:{name}"))
                if "pod" in batch_axes:
                    rows.append(_row("all-reduce", 1, piece,
                                     mesh.shape["pod"],
                                     f"grad_all_reduce:{name}"))
        elif kind == "train" and batch_axes:
            g = math.prod(mesh.shape[a] for a in batch_axes)
            rows.append(_row("all-reduce", 1, piece, g,
                             f"grad_all_reduce:{name}"))
        row_parallel = (len(s.shape) == 2 and s.decl.axes[-1] == "p_embed"
                        and s.decl.axes[0] in ("p_heads", "p_mlp")
                        and "model" in spec[0])
        if tp and row_parallel:
            S_act = (cfg.encoder.n_frames if path[0] == "encoder"
                     else 1 if kind == "decode" else S)
            g = mesh.shape["model"]
            rows.append(_row("all-reduce", passes,
                             B // dp * S_act * cfg.d_model * item, g,
                             f"tp_all_reduce:{name}"))
        if (cfg.moe_impl == "gather" and path[-1] == "gate"
                and len(path) >= 2 and path[-2] == "moe"
                and "model" in spec[0]):
            g = mesh.shape["model"]
            toks = B * (1 if kind == "decode" else S)
            C = _capacity(toks, cfg.n_experts, cfg.top_k,
                          cfg.capacity_factor)
            buf = cfg.n_experts * C * cfg.d_model * item / (dp * g)
            rows.append(_row("all-to-all", 2 * passes, buf, g,
                             f"moe_dispatch:{'.'.join(map(str, path[:-1]))}"))
    return rows


def summarize_collectives(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The reference's per-kind dict (count, bytes and wire bytes per
    device, each row's payload times its count) plus ``total_bytes``,
    ``total_wire_bytes`` and the rows themselves."""
    out: Dict[str, Any] = {k: {"count": 0.0, "bytes": 0.0,
                               "wire_bytes": 0.0} for k in COLL_KINDS}
    for r in rows:
        agg = out[r["kind"]]
        agg["count"] += r["count"]
        agg["bytes"] += r["count"] * r["bytes"]
        agg["wire_bytes"] += r["count"] * r["wire_bytes"]
    out["total_bytes"] = sum(out[k]["bytes"] for k in COLL_KINDS)
    out["total_wire_bytes"] = sum(out[k]["wire_bytes"] for k in COLL_KINDS)
    out["rows"] = rows
    return out


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, cfg_override=None, tag: str = "",
             extras: Optional[Dict[str, Any]] = None,
             shape_override: Optional[ShapeSpec] = None) -> Dict[str, Any]:
    """Run one cell's step on meta tensors; return its record.
    ``shape_override`` replaces ``SHAPES[shape_name]`` (its rules stay
    those of ``shape_name``), as ``cfg_override`` replaces the config."""
    shape = shape_override or SHAPES[shape_name]
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = default_rules(multi_pod,
                          long_context=(shape_name == "long_500k"),
                          seq_shard=cfg.seq_shard, serve=cfg.serve_rules)
    n_dev = mesh.size
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(v) for v in mesh.shape.values()),
        "multi_pod": multi_pod, "n_devices": n_dev, "kind": shape.kind,
        "tag": tag,
    }
    if extras:
        rec.update(extras)
    set_mesh_rules(mesh, rules)
    try:
        fn, args, state_specs = build_step_fn(cfg, shape, mesh, rules)
        m = measure(fn, args)
        del fn, args
        rec["run_s"] = m["run_s"]
        rec_fl = _recurrence_flops(cfg, shape.kind, shape.global_batch,
                                   shape.seq_len)
        rec["flops_counted"] = m["flops"]
        rec["flops_by_op"] = m["flops_by_op"]
        rec["flops_recurrence_analytic"] = rec_fl
        rec["flops_global"] = m["flops"] + rec_fl
        rec["flops_per_device"] = rec["flops_global"] / n_dev
        rec["bytes_global_unfused"] = m["bytes_unfused"]
        rec["peak_live_bytes_global"] = m["peak_live_bytes"]
        rec["state_bytes_per_device"] = SP.state_bytes_per_device(
            state_specs)
        rec["collectives"] = summarize_collectives(
            m["issued"] + modelled_collectives(cfg, shape, mesh, rules))
        rec["params_total"] = T.param_count(cfg)
        rec["params_active"] = T.active_param_count(cfg)
        rec["status"] = "ok"
        if verbose:
            c = rec["collectives"]
            print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}"
                  f"{' [' + tag + ']' if tag else ''}: OK  "
                  f"run {rec['run_s']:.1f}s")
            print(f"  flops/dev={rec['flops_per_device']:.4e} "
                  f"(global {rec['flops_global']:.4e}) "
                  f"unfused bytes={rec['bytes_global_unfused']:.3e} "
                  f"peak live={rec['peak_live_bytes_global']:.3e}")
            print(f"  state bytes/dev: {rec['state_bytes_per_device']:.4e}")
            print("  collectives/dev: " + ", ".join(
                f"{k}={c[k]['bytes']:.2e}B({c[k]['count']:.0f})"
                for k in COLL_KINDS if c[k]["count"])
                + f"; wire {c['total_wire_bytes']:.3e}B")
    except Exception as e:  # noqa: BLE001 — recorded, then raised
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {rec['mesh']}: "
                  f"FAILED — {rec['error']}")
        raise
    finally:
        clear_mesh_rules()
    return rec


def save_record(rec: Dict[str, Any], out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    mesh_tag = "multi" if rec["multi_pod"] else "single"
    tag = f"__{rec['tag']}" if rec.get("tag") else ""
    path = os.path.join(
        out_dir, f"{rec['arch']}__{rec['shape']}__{mesh_tag}{tag}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every supported cell on both meshes")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    if args.all:
        failures = []
        for arch in ARCH_IDS:
            for shape_name in SHAPES:
                ok, why = cell_supported(arch, shape_name)
                if not ok:
                    print(f"[dryrun] {arch} x {shape_name}: SKIP ({why})")
                    continue
                meshes = [False] if args.single_pod_only else [False, True]
                for mp in meshes:
                    try:
                        rec = run_cell(arch, shape_name, mp)
                        save_record(rec, args.out)
                    except Exception as e:  # noqa: BLE001
                        failures.append((arch, shape_name, mp, str(e)))
        if failures:
            print(f"[dryrun] {len(failures)} FAILURES:")
            for f in failures:
                print("   ", f)
            raise SystemExit(1)
        print("[dryrun] all cells OK")
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    rec = run_cell(args.arch, args.shape, args.multi_pod)
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("collectives",)}, indent=1))
    save_record(rec, args.out)


if __name__ == "__main__":
    main()
