"""ctypes binding of the native (C++) pair search of the host neighbor build.

The port's own copy of lammps_plugins_tpu/ops/native.py, which the port
does not import.  The source is csrc/neighbor_native.cpp; g++ builds it
at first use into build/native/ at the repository root (listed in
.gitignore), never next to the source, and rebuilds it when the source
is newer.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "neighbor_native.cpp")
LIB_PATH = os.path.join(os.path.dirname(_PKG), "build", "native",
                        "libneighbor_native.so")

_lock = threading.Lock()
_lib = None


def _build():
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
           "-pthread", SRC, "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    if res.returncode != 0:
        raise RuntimeError(f"g++ build of {SRC} failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, LIB_PATH)


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(LIB_PATH) or \
                os.path.getmtime(LIB_PATH) < os.path.getmtime(SRC):
            _build()
        lib = ctypes.CDLL(LIB_PATH)
        lib.lpt_find_pairs.restype = ctypes.c_int64
        lib.lpt_find_pairs.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ]
        lib.lpt_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def find_pairs(x_own: np.ndarray, x_all: np.ndarray, rcut: float,
               nthreads: int = 0):
    """Every (i, j) with |x_own[i] - x_all[j]| < rcut, i != j: returns
    (pi int32, pj int32, rsq float64), thread-major order."""
    lib = get_lib()
    x_own = np.ascontiguousarray(x_own, dtype=np.float64)
    x_all = np.ascontiguousarray(x_all, dtype=np.float64)
    pi = ctypes.POINTER(ctypes.c_int32)()
    pj = ctypes.POINTER(ctypes.c_int32)()
    rsq = ctypes.POINTER(ctypes.c_double)()
    n = lib.lpt_find_pairs(
        x_own.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(x_own),
        x_all.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(x_all),
        float(rcut), int(nthreads),
        ctypes.byref(pi), ctypes.byref(pj), ctypes.byref(rsq))
    try:
        out_i = np.ctypeslib.as_array(pi, shape=(n,)).copy() if n else \
            np.zeros(0, np.int32)
        out_j = np.ctypeslib.as_array(pj, shape=(n,)).copy() if n else \
            np.zeros(0, np.int32)
        out_r = np.ctypeslib.as_array(rsq, shape=(n,)).copy() if n else \
            np.zeros(0)
    finally:
        lib.lpt_free(pi)
        lib.lpt_free(pj)
        lib.lpt_free(rsq)
    return out_i, out_j, out_r
