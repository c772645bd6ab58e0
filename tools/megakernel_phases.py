#!/usr/bin/env python3
"""Time the phases of the fused-network megakernel on a real window.

The committed kernel carries no timing code.  This script copies a tree
into ``build/phase_probe/``, instruments the copy's
``csrc/network_window.cu`` with ``clock64()`` per phase, builds it,
serves the window ``chip_smoke.py`` phase 2c runs (the 1.2% cohort, 8
slots, T = 4, after three served windows), launches the megakernel on it
under both pairings and prints each phase's share of a block's cycles
and that share of the kernel's back-to-back time.  It knows two kernels:

* PR 14's (commit 0800902: one 512-thread block per slot): thread 0 of
  each block adds the cycles since its last mark, with no barrier added;
* PR 15's (a cluster of 8 CTAs per slot): each mark follows a block
  barrier, so a phase's cycles are the CTA's, its slowest warp included
  (the barriers cost a little themselves); the time a CTA waits at the
  routing steps' cluster barriers is its own phase, and the CTAs' busy
  cycles (all but that wait) show how evenly a slot's work is spread.

Optionally it also builds and runs ``tools/cluster_probe.cu`` (cluster
occupancy and barrier costs).

Usage, on a machine with a CUDA card and nvcc, from the repository root:

    git archive 0800902 src chip_smoke.py tests/golden | \\
        (mkdir -p build/parent && tar -x -C build/parent)
    python3 tools/megakernel_phases.py --tree build/parent --cluster-probe
    python3 tools/megakernel_phases.py --tree .       # this tree's kernel

Writes ``chiprun_out/megakernel_phases.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import shutil
import subprocess
import sys
from typing import Tuple

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROBE = ROOT / "build" / "phase_probe"
PHASES = ["staging", "leak", "conv walk", "pool walk", "fc walk", "sweeps",
          "routing", "write-back", "total", "event staging", "frozen"]
# PR 15's phases, by counter: conv, pool and fc scatter each hold their
# layers' event filter and walk; the segment table is the routed list's
CLUSTER_PHASES = {0: "staging", 1: "leak", 3: "segment table",
                  5: "conv scatter", 6: "pool scatter", 7: "fc scatter",
                  9: "sweeps", 10: "routing", 11: "write-back",
                  12: "cluster barrier wait"}

# (text of the PR 14 kernel, instrumented text): each must occur once
_PATCHES = [
    ("namespace {\n\nconstexpr int kThreads = 512;",
     "__device__ unsigned long long g_ph[64][16];\nnamespace {\n\n"
     "constexpr int kThreads = 512;"),
    ("  const int L = net.L, T = net.T, E0 = net.E0;\n",
     "  const int L = net.L, T = net.T, E0 = net.E0;\n"
     "  unsigned long long ph[16] = {0};\n"
     "  long long t_mark = clock64(), t_begin = t_mark;\n"
     "#define PH(k) do { if (tid == 0) { long long t_now = clock64(); "
     "ph[k] += t_now - t_mark; t_mark = t_now; } } while (0)\n"),
    ("    if (tid == 0) tally[0] = total;\n  }\n",
     "    if (tid == 0) tally[0] = total;\n  }\n  PH(0);\n"),
    ("          slab[i] = sne::leak_step(slab[i], ly.p);\n      }\n",
     "          slab[i] = sne::leak_step(slab[i], ly.p);\n      }\n"
     "      PH(1);\n"),
    ("        __syncthreads();                    // leak and stage are done\n"
     "        walk_events<Wt, Acc>(ly, slab, wsh, cnt, st_x, st_y, st_c, "
     "st_g);\n"
     "        __syncthreads();                    // the stage may be "
     "refilled\n",
     "        __syncthreads();                    // leak and stage are done\n"
     "        PH(9);\n"
     "        walk_events<Wt, Acc>(ly, slab, wsh, cnt, st_x, st_y, st_c, "
     "st_g);\n"
     "        __syncthreads();                    // the stage may be "
     "refilled\n"
     "        PH(2 + ly.kind);\n"),
    ("      if (!routed) break;", "      if (!routed) { PH(5); break; }"),
    ("      __syncthreads();                      // the frame's words are "
     "done\n",
     "      __syncthreads();                      // the frame's words are "
     "done\n      PH(5);\n"),
    ("      __syncthreads();                      // the ring is complete\n"
     "    }\n  }\n",
     "      __syncthreads();                      // the ring is complete\n"
     "      PH(6);\n    }\n  }\n  PH(10);\n"),
    ("  __syncthreads();                          // thread 0's tallies\n",
     "  __syncthreads();                          // thread 0's tallies\n"
     "  PH(7);\n"
     "  if (tid == 0) { ph[8] = clock64() - t_begin; "
     "for (int k = 0; k < 16; ++k) g_ph[n][k] = ph[k]; }\n"),
]
_MARK = ("#define PH(k) do { __syncthreads(); if (threadIdx.x == 0) { "
         "long long t_now = clock64(); ph[k] += t_now - t_mark; "
         "t_mark = t_now; } } while (0)\n")
# (text of the PR 15 kernel, instrumented text): each must occur once
_CLUSTER_PATCHES = [
    ("namespace {\n\nusing sne::conv::Band;",
     "__device__ unsigned long long g_ph[64][16];\n" + _MARK +
     "namespace {\n\nusing sne::conv::Band;"),
    ("  extern __shared__ __align__(16) unsigned char smem[];\n"
     "  cg::cluster_group cluster = cg::this_cluster();\n",
     "  extern __shared__ __align__(16) unsigned char smem[];\n"
     "  unsigned long long ph[16] = {0};\n"
     "  long long t_mark = clock64(), t_begin = t_mark;\n"
     "  cg::cluster_group cluster = cg::this_cluster();\n"),
    ("  __syncthreads();                          // the masks are in\n",
     "  __syncthreads();                          // the masks are in\n"
     "  PH(0);\n"),
    ("      // scatter: filter the events a stage at a time, walk what was "
     "kept\n",
     "      PH(1);\n"
     "      // scatter: filter the events a stage at a time, walk what was "
     "kept\n"),
    ("        __syncthreads();                    // the segment table is in\n",
     "        __syncthreads();                    // the segment table is in\n"
     "        PH(3);\n"),
    ("      // clip, fire, reset (hot sites) and clamp, by each owner; spikes "
     "go\n",
     "      PH(5 + ly.kind);\n"
     "      // clip, fire, reset (hot sites) and clamp, by each owner; spikes "
     "go\n"),
    ("      if (!routed) break;\n", "      PH(9);\n      if (!routed) break;\n"),
    ("      cluster.sync();                       // every rank's list is out\n",
     "      PH(10);\n"
     "      cluster.sync();                       // every rank's list is out\n"
     "      PH(12);\n"),
    ("  __syncthreads();                          // thread 0's tallies\n",
     "  PH(11);\n"
     "  __syncthreads();                          // thread 0's tallies\n"),
    ("  cluster.sync();                           // no list is read any more\n"
     "}\n",
     "  cluster.sync();                           // no list is read any more\n"
     "  if (threadIdx.x == 0) { ph[8] = clock64() - t_begin; "
     "for (int k = 0; k < 16; ++k) g_ph[blockIdx.x][k] = ph[k]; }\n}\n"),
]
_READER = """
extern "C" int sne_network_phases(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_ph, sizeof(g_ph));
}
"""


def instrument(tree: pathlib.Path) -> Tuple[pathlib.Path, bool]:
    """Copy ``tree`` to build/phase_probe and instrument its megakernel;
    returns the copy and whether it is the cluster (PR 15) kernel."""
    if PROBE.exists():
        shutil.rmtree(PROBE)
    shutil.copytree(tree, PROBE, ignore=shutil.ignore_patterns(
        "build", "chiprun_out", ".git"))
    src = PROBE / "src" / "repro_torch" / "kernels" / "csrc" / \
        "network_window.cu"
    text = src.read_text()
    cluster = "cg::this_cluster()" in text
    for old, new in _CLUSTER_PATCHES if cluster else _PATCHES:
        if text.count(old) != 1:
            raise SystemExit(f"{src}: not the PR {15 if cluster else 14} "
                             f"megakernel (missing {old[:60]!r})")
        text = text.replace(old, new)
    src.write_text(text + _READER)
    return PROBE, cluster


def cluster_probe() -> str:
    exe = ROOT / "build" / "cluster_probe"
    subprocess.run(["nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-o", str(exe),
                    str(ROOT / "tools" / "cluster_probe.cu")], check=True)
    return subprocess.run([str(exe)], capture_output=True, text=True,
                          check=True).stdout


def measure(probe: pathlib.Path, cluster: bool) -> dict:
    import numpy as np
    import torch
    sys.path.insert(0, str(probe))
    sys.path.insert(0, str(probe / "src"))
    import chip_smoke as cs
    from repro_torch.core import layer_program as lp
    from repro_torch.core.policies import ExecutionPolicy
    from repro_torch.core.quant import quantize_net
    from repro_torch.core.sne_net import dvs_gesture_net, init_snn
    from repro_torch.kernels import _build
    from repro_torch.serve import EventServeEngine
    dev = torch.device("cuda", 0)
    _build.build_all()
    lib = _build.library("network_window")
    spec = dvs_gesture_net()
    qn = quantize_net(init_snn(np.random.default_rng(0), spec, device=dev),
                      spec)
    out = {"card": cs.nvidia_smi()}
    for dp, pairing in (("f32-carrier", "f32"), ("int8-native", "native")):
        eng = EventServeEngine(qn.spec, qn.params_for(dp), n_slots=cs.N_SLOTS,
                               window=cs.WINDOW, device=dev,
                               policy=ExecutionPolicy(dtype_policy=dp))
        for r in cs._cohort(spec, cs.COHORTS[cs.WINDOW_COHORT][1], 100,
                            cs.N_SLOTS, spec.n_timesteps):
            assert eng.try_admit(r)
        for _ in range(cs.WARM_WINDOWS):
            eng.step()
        params, states, window, program = cs._capture_window(eng)
        net_prog = lp.compile_program(
            program.spec, program.step_capacities, ExecutionPolicy(
                dtype_policy=program.dtype_policy,
                fusion_policy="fused-network",
                tile_sparsity=program.tile_sparsity), device=dev)
        launch = lp.network_launch(params, states, *window, program=net_prog)
        ms = cs.cuda_ms(launch.run, 20)
        launch.run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (64 * 16))()
        if lib.sne_network_phases(buf) != 0:
            raise SystemExit("could not read the phase counters")
        blocks = cs.N_SLOTS * (8 if cluster else 1)
        ph = np.frombuffer(buf, dtype=np.uint64).reshape(64, 16)
        ph = ph[:blocks].astype(np.float64)
        total = ph[:, 8].mean()
        names = CLUSTER_PHASES if cluster else dict(enumerate(PHASES))
        phases = {name: {"cycles": ph[:, k].mean(),
                         "share": ph[:, k].mean() / total,
                         "ms": ms * ph[:, k].mean() / total}
                  for k, name in names.items() if k != 8}
        out[pairing] = {"ms": ms, "cycles": total, "phases": phases}
        if cluster:
            # cycles each CTA of slot 0 spent off the cluster barriers
            busy = ph[:8, 8] - ph[:8, 12]
            out[pairing]["slot0_busy_cycles"] = busy.tolist()
            print(f"  busy cycles of slot 0's CTAs: "
                  f"{[int(b) for b in busy]}")
        print(f"{pairing}: kernel {ms:.4f} ms back to back, {total:.0f} "
              f"cycles a block [{out['card']}]")
        for name, r in sorted(phases.items(), key=lambda kv: -kv[1]["share"]):
            print(f"  {name:14s} {r['share']:7.2%}  {r['ms']:.4f} ms")
    out["clocks"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, type=pathlib.Path,
                    help="an unpacked tree holding the PR 14 or the PR 15 "
                    "megakernel")
    ap.add_argument("--cluster-probe", action="store_true",
                    help="also build and run tools/cluster_probe.cu")
    args = ap.parse_args()
    out = {}
    if args.cluster_probe:
        out["cluster_probe"] = cluster_probe()
        print(out["cluster_probe"])
    out.update(measure(*instrument(args.tree.resolve())))
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    with open(ROOT / "chiprun_out" / "megakernel_phases.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
