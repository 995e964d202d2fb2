"""Build + ctypes-load the native Gaussian-filter library.

The library compiles with ``g++`` on first use into this package directory
and binds through its plain C ABI. It backs the energy-convention
calibration and the ``"native"`` CRF backend; a failed build raises, and
nothing falls back to the port's torch lattice in its place.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "gaussian_filter.cpp")
_LIB = os.path.join(_DIR, "libcosa_native.so")
_LOCK = threading.Lock()
_CACHED: Optional[ctypes.CDLL] = None


def _compile() -> None:
    # build to a private name, then rename: test workers that start at once
    # never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_DIR)
    os.close(fd)
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
        "-std=c++17", "-o", tmp, _SRC,
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"g++ failed to build the native lattice:\n{res.stderr}"
            )
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_native(rebuild: bool = False) -> ctypes.CDLL:
    global _CACHED
    with _LOCK:
        if _CACHED is not None and not rebuild:
            return _CACHED
        if rebuild or not os.path.exists(_LIB) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        ):
            _compile()
        lib = ctypes.CDLL(_LIB)
        fp = ctypes.POINTER(ctypes.c_float)
        lib.cosa_exact_gaussian.argtypes = [fp, fp, fp] + [ctypes.c_int] * 3
        lib.cosa_lattice_gaussian.argtypes = [fp, fp, fp] + [ctypes.c_int] * 3
        lib.cosa_lattice_gaussian_batch.argtypes = [fp, fp, fp] + [ctypes.c_int] * 4
        _CACHED = lib
        return lib


def _call(fname: str, feats: np.ndarray, vals: np.ndarray) -> np.ndarray:
    lib = load_native()
    feats = np.ascontiguousarray(feats, np.float32)
    vals = np.ascontiguousarray(vals, np.float32)
    n, d = feats.shape
    k = vals.shape[1]
    out = np.zeros_like(vals)
    fp = ctypes.POINTER(ctypes.c_float)
    getattr(lib, fname)(
        feats.ctypes.data_as(fp), vals.ctypes.data_as(fp),
        out.ctypes.data_as(fp), n, d, k,
    )
    return out


def exact_gaussian_cpu(feats: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """(N, d) x (N, K) exact Gaussian transform on the host (OpenMP)."""
    return _call("cosa_exact_gaussian", feats, vals)


def lattice_gaussian_cpu(feats: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """(N, d) x (N, K) permutohedral transform on the host (OpenMP)."""
    return _call("cosa_lattice_gaussian", feats, vals)
