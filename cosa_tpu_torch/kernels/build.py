"""Build the CUDA kernels with ``nvcc`` and load them through ctypes.

Each source in ``cosa_tpu_torch/csrc`` compiles at first use into its own
shared library with a plain C interface, under ``build/cosa_tpu_torch/`` at
the root of the checkout. A library's name carries a hash of its source, so
an edited source is rebuilt and never mixed up with a stale library. The
sources of one call to :func:`build` compile in parallel, one ``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cosa_tpu_torch")
SOURCES = {"flash": "flash_attn.cu", "rff": "rff_phi.cu", "tta_fuse": "tta_fuse.cu",
           "window_attn": "window_attn.cu", "cam2mask": "cam2mask.cu"}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report (registers, shared memory, spills) per source
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile the named sources (default: all) that are not built yet, all
    at once. Returns the wall seconds spent; raises on any nvcc failure."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not os.path.exists(_lib_path(n))]
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.time()
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        final = _lib_path(n)
        tmp = f"{final}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[n])]
        procs[n] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, final)
    failed = []
    for n, (p, tmp, final) in procs.items():
        log, _ = p.communicate()
        BUILD_LOG[n] = log
        if p.returncode != 0:
            failed.append(f"{SOURCES[n]}:\n{log}")
        else:
            os.replace(tmp, final)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.time() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            _LIBS[name] = lib
        return lib
