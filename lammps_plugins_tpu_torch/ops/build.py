"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Every csrc/*.cu compiles with its own nvcc process, all started together,
and one more nvcc links the objects into a shared library with a plain C
interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
         -Xcompiler -fPIC -Xptxas -v -c csrc/X.cu -o build/torch_kernels/X.o
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \
         -o build/torch_kernels/liblpt_kernels.so build/torch_kernels/*.o

The library is built at first use, from the checkout's sources alone, into
build/torch_kernels/ at the repository root (listed in .gitignore), and
rebuilt when any source is newer than it.  A failed build raises.  Nothing
here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "liblpt_kernels.so")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_lib = None
#: nvcc's output (with -Xptxas -v: registers, shared memory, spills) from
#: the build this process ran, or "" when the library was up to date
build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "lpt_rebo_cotangents": [_P] * 11 + [_I] * 4 + [_P],
    "lpt_mirror_combine": [_P] * 6 + [_I, _I, _P],
    "lpt_lj_cell_forces": [_P] * 3 + [_I] * 10 + [_P, _P, _I, _I, _P],
    "lpt_select_k": [_P, _P, _P, _I, _P, _P, _P] + [_I] * 5 + [_P],
    "lpt_pin_copy": [_P, _P, _I, _I, _P],
    "lpt_mirror_combine_rows": [_P] * 6 + [_I, _I, _P],
    "lpt_lj_cell_forces_half": [_P] * 4 + [_I] * 9 + [_P, _P, _I],
    "lpt_react_combine": [_P] * 5 + [_I] * 3 + [_P],
    "lpt_select_candidates": [_P] * 10 + [ctypes.c_float] + [_I] * 13 + [_P],
    "lpt_graph_if_then": [_P] * 4,
    "lpt_graph_instantiate": [_P, _P],
    "lpt_graph_launch": [_P, _P],
    "lpt_graph_destroy": [_P, _P],
    "lpt_stamp": [_P, _I, _P],
    "lpt_ljcut_forces": [_P] * 14 + [_I] * 4 + [ctypes.c_float] * 2 + [_P],
}


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in sources())


def _build() -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    cus = [s for s in sources() if s.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)[:-3]}.{tag}.o")
            for s in cus]
    procs = [subprocess.Popen(
        [nvcc, *ARCH_FLAGS, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v", "-c", src, "-o", obj],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(cus, objs)]
    log, failed = [], []
    for src, p in zip(cus, procs):
        out, _ = p.communicate(timeout=900)
        log.append(out)
        if p.returncode != 0:
            failed.append(f"{os.path.basename(src)} ({p.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = f"{LIB_PATH}.{tag}.tmp"
    res = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, LIB_PATH)
    for obj in objs:
        os.remove(obj)
    return "".join(log) + res.stdout + res.stderr


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or stale."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            if _stale():
                build_log = _build()
            cdll = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = cdll
        return _lib


def use_kernel(t: torch.Tensor, name: str) -> bool:
    """Dispatch rule: CPU -> twin (False), CUDA float32 -> kernel (True);
    any other device or dtype raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: CUDA kernel takes float32, got {t.dtype}")
    return True


def check(t: torch.Tensor, name: str, shape, dtype, device) -> int:
    """Validate a kernel argument and return its data pointer."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


#: large enough that no table a captured graph reads is evicted (and freed)
#: while the graph lives: a few tables a kernel, device and plan
@functools.lru_cache(maxsize=256)
def device_constants(values: tuple, device: torch.device,
                     dtype=torch.float32) -> torch.Tensor:
    """A small constant table (a kernel's float32 constants, a grid's
    dimensions) on `device`, uploaded once.  An upload from host memory at
    every call would synchronise the stream, and a CUDA graph cannot
    capture it; callers only read the cached tensor."""
    return torch.tensor(values, dtype=dtype, device=device)


def raise_on_error(status: int, name: str):
    """Raise unless the C entry point returned 0 (cudaSuccess)."""
    if status != 0:
        raise RuntimeError(f"{name}: launch failed with status {status}")
