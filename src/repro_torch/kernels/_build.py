"""Build the CUDA sources of the port once, at first use, and load them.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, into a shared library with a plain C interface
(``-gencode arch=compute_90a,code=sm_90a``), then loaded with ``ctypes``.
The libraries land in ``build/torch_kernels/`` at the repository root,
named by a hash of source and flags, so a stale build is never loaded.
Nothing is built when the module is imported: the CPU tests import every
module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the window launchers' LIF plan: threshold, leak, clip; the three modes
_LIF = [_F] * 3 + [_I] * 3
# C signature of each library's launcher: pointers, then ints (and the
# window kernels' LIF plan), then stream
_SIGNATURES = {
    "event_conv": ("sne_event_conv_batched", [_P] * 5 + [_I] * 10 + [_P]),
    "event_pool": ("sne_event_pool_batched", [_P] * 5 + [_I] * 8 + [_P]),
    "event_fc": ("sne_event_fc_batched", [_P] * 5 + [_I] * 8 + [_P]),
    "event_conv_window": ("sne_event_conv_window",
                          [_P] * 8 + [_I] * 16 + _LIF + [_P]),
    "event_pool_window": ("sne_event_pool_window",
                          [_P] * 8 + [_I] * 13 + _LIF + [_P]),
    "event_fc_window": ("sne_event_fc_window",
                        [_P] * 7 + [_I] * 9 + _LIF + [_P]),
    # host arrays (layer descriptors, LIF floats, pointers), then as named
    "network_window": ("sne_network_window",
                       [_P] * 3 + [_I] + [_P] * 6 + [_I] * 15 + [_P]),
    "lif_fused": ("sne_lif_fused", [_P] * 5 + [_I] + [_F] * 3 + [_I, _P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}     # compiler output per source (-Xptxas -v)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _target(src: pathlib.Path) -> pathlib.Path:
    # every header (walk_common, lif_common, scatter_common, pool_walk,
    # conv_walk, fc_walk) is a dependency of every source
    h = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every missing library in parallel; return the seconds spent.

    Raises with the compiler's output if any ``nvcc`` fails.
    """
    with _lock:
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            out = _target(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((src, out, tmp, proc))
        failed = []
        for src, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            BUILD_LOG[src.name] = log
            if proc.returncode != 0:
                failed.append(f"{src.name} (rc {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built at first use)."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is not None:
        return lib
    build_all()
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_target(CSRC / f"{name}.cu")))
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]
