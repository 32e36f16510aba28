"""Builds the package's CUDA kernels on first use.

Every ``.cu`` source in ``dgll_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` process per source, all started together) and linked into
one shared library with a plain C interface, which is loaded with ctypes. The
library's file name carries a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded from ``build/dgll_tpu_torch/`` at the root of
the checkout.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "dgll_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdgll_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library of the same hash exists; return its path.

    The compiler's output (``-Xptxas=-v``: registers, shared memory, spills per
    kernel) is kept beside the library as ``<name>.log``.
    """
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{so.stem}.{os.getpid()}"
    nvcc = nvcc_path()
    objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)]
    tmp = so.with_name(f"{stem}.so.tmp")
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in cmds]
        # wait for every compile before looking at any, so that none is left running
        log = [proc.communicate()[0] for proc in procs]
        for cmd, proc, out in zip(cmds, procs, log):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                                   f"{' '.join(cmd)}\n{out}")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    so.with_suffix(".log").write_text("".join(log) + proc.stdout + proc.stderr)
    os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial file
    return so


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C interface of every kernel."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    f, ll, ull = ctypes.c_float, ctypes.c_longlong, ctypes.c_ulonglong
    signatures = {
        "dgll_quantize_int8": [p, p, p, p, ll, i, i, ull, p],
        "dgll_quantize_int8_fill": [p] * 5 + [ll, i, i, ull, p],
        "dgll_spmm_csr": [p] * 6 + [i] * 5 + [p] * 5 + [i] * 3 + [p],
        "dgll_spmm_csr_bf16": [p] * 6 + [i] * 5 + [p] * 5 + [i] * 2 + [p] * 2 + [i] * 2
                              + [p],
        "dgll_spmm_windowed": [p] * 10 + [i] * 6 + [p],
        "dgll_gat_stats": [p] * 6 + [i] * 4 + [f] + [p] * 6 + [i] * 3 + [p],
        "dgll_gat_alpha": [p] * 7 + [ll, i, f, i, i, p],
        "dgll_edges_to_rows_sum": [p] * 4 + [i] * 4 + [p] * 5 + [i] * 3 + [p],
        "dgll_edges_to_rows_max": [p] * 4 + [i] * 4 + [p] * 5 + [i] * 3 + [p],
        "dgll_gat_bwd_softmax": [p] * 8 + [i] * 4 + [p] * 5 + [i] * 3 + [p],
        "dgll_expand_rows": [p, p, p, ll, i, i, i, p],
        "dgll_rows_to_edges_multi": [p, p, p, ll, i, i, i, p],
        "dgll_sddmm": [p, p, p, p, ll, i, i, i, p],
        "dgll_probe_copy": [p, p, ll, p],
        "dgll_probe_dynread": [p, p, p, ll, i, i, p],
        "dgll_probe_onehot": [p, p, p, ll, i, i, p],
        "dgll_probe_dynacc": [p, p, p, ll, i, i, p],
        "dgll_probe_gather": [p] * 5 + [ll] + [i] * 6 + [p],
        "dgll_gcnii_fused_fwd": [p] * 7 + [i] * 2 + [f] * 5 + [p],
        "dgll_gcnii_fused_bwd": [p] * 8 + [i] * 4 + [f] * 5 + [p],
        "dgll_gcnii_fused_bwd_blocks": [i],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, i
    lib.dgll_cuda_error_string.argtypes = [i]
    lib.dgll_cuda_error_string.restype = ctypes.c_char_p
    return lib
