"""ctypes loader for the host graph kernels (``csrc/graph_kernels.cpp``).

The C++ source is the port's own copy of the JAX package's host library (ABI 3):
the port reads no file of the JAX package. ``g++`` compiles it on first use into
``build/dgll_tpu_torch/`` at the root of the checkout, under a name that carries a
hash of the source. Each entry point has the numpy fallback the JAX loader has,
taken when no compiler is there or the build fails; ``native_available()`` says
which path runs.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE = PACKAGE_DIR / "csrc" / "graph_kernels.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "dgll_tpu_torch"
ABI_VERSION = 3  # dgll_abi_version() of the source this loader binds
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")


def _build() -> Optional[Path]:
    """Compile the source unless a library of the same hash exists; None on failure."""
    if not SOURCE.exists():
        return None
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"libdgll_host_{h}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial file
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return so


@functools.cache
def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library with its entry points declared, or None (numpy fallback)."""
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
        lib.dgll_abi_version.restype = ctypes.c_int
        if lib.dgll_abi_version() != ABI_VERSION:
            return None
    except (OSError, AttributeError):
        return None
    i64p, i64 = ctypes.POINTER(ctypes.c_int64), ctypes.c_int64
    lib.dgll_remap.argtypes = [i64p, i64p, i64, i64p]
    lib.dgll_label_propagation.argtypes = [i64p, i64p, i64, i64, i64p]
    return lib


def native_available() -> bool:
    return get_lib() is not None


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def remap(mapping: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``out[i] = mapping[idx[i]]`` as int64, multithreaded; numpy fancy indexing
    where the library is missing."""
    lib = get_lib()
    if lib is None:
        return np.asarray(mapping, np.int64)[np.asarray(idx, np.int64)]
    mapping = np.ascontiguousarray(mapping, np.int64)
    idx = np.ascontiguousarray(idx, np.int64)
    out = np.empty(len(idx), np.int64)
    lib.dgll_remap(_p64(mapping), _p64(idx), len(idx), _p64(out))
    return out


def label_propagation(indptr: np.ndarray, nbrs: np.ndarray, n: int, max_iters: int,
                      labels: np.ndarray) -> bool:
    """In-place asynchronous label propagation over the in-edge CSR ``(indptr,
    nbrs)``; returns False, leaving ``labels`` as they were, if the library is
    missing (the caller then runs its numpy version). Graphs under 16,384 nodes run
    on one thread and give the same labels on every run."""
    lib = get_lib()
    if lib is None:
        return False
    if labels.dtype != np.int64 or not labels.flags["C_CONTIGUOUS"]:
        raise ValueError("labels: need a contiguous int64 array, updated in place")
    lib.dgll_label_propagation(
        _p64(np.ascontiguousarray(indptr, np.int64)),
        _p64(np.ascontiguousarray(nbrs, np.int64)),
        n, max_iters, _p64(labels),
    )
    return True
