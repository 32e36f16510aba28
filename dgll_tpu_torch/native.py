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
from typing import Optional, Tuple

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
    u8p, i32p, u64 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32), ctypes.c_uint64
    lib.dgll_remap.argtypes = [i64p, i64p, i64, i64p]
    lib.dgll_label_propagation.argtypes = [i64p, i64p, i64, i64, i64p]
    lib.dgll_sample_neighbors.argtypes = [i64p, i64p, i64p, u8p, i64, i64, u64, i64p, u8p]
    lib.dgll_sample_block_fused.argtypes = [i64p, i64p, i64p, i64, i64, i64, i64, u64,
                                            i32p, u8p]
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.dgll_build_csr_apply.argtypes = [i64p, i64p, f32p, i64, i64, i64p, i32p, i32p,
                                         f32p]
    lib.dgll_partition_pack.argtypes = [i64p, i64p, f32p, i64, i64, i64, i64, i32p, i32p,
                                        f32p]
    lib.dgll_random_walks.argtypes = [i64p, i64p, i64p, i64, i64, u64, i64p]
    lib.dgll_node2vec_walks.argtypes = [i64p, i64p, i64p, i64, i64, ctypes.c_double,
                                        ctypes.c_double, u64, i64p]
    lib.dgll_sort_rows.argtypes = [i64p, i64, i64p]
    return lib


def native_available() -> bool:
    return get_lib() is not None


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _pu8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def sample_neighbors(indptr: np.ndarray, nbrs: np.ndarray, nodes: np.ndarray,
                     mask: np.ndarray, fanout: int, seed: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """``[b, fanout]`` with-replacement neighbour sample and its validity mask.
    Zero-degree or masked rows give the node's own id with mask 0. The library seeds
    its generator per worker chunk, so its draws depend on the core count; the numpy
    fallback (``_np_sample``) draws from ``default_rng(seed)``."""
    lib = get_lib()
    b = len(nodes)
    if lib is None:
        return _np_sample(indptr, nbrs, nodes, mask, fanout, seed)
    nodes = np.ascontiguousarray(nodes, np.int64)
    mask8 = np.ascontiguousarray(mask, np.uint8)
    out = np.empty(b * fanout, np.int64)
    om = np.empty(b * fanout, np.uint8)
    lib.dgll_sample_neighbors(
        _p64(np.ascontiguousarray(indptr, np.int64)),
        _p64(np.ascontiguousarray(nbrs, np.int64)),
        _p64(nodes), _pu8(mask8), b, fanout, seed & 0xFFFFFFFFFFFFFFFF,
        _p64(out), _pu8(om),
    )
    return out.reshape(b, fanout), om.reshape(b, fanout).astype(bool)


def _np_sample(indptr, nbrs, nodes, mask, fanout, seed):
    rng = np.random.default_rng(seed)
    nodes = np.asarray(nodes, np.int64)
    deg = indptr[nodes + 1] - indptr[nodes]
    start = indptr[nodes]
    valid = (deg > 0) & np.asarray(mask, bool)
    off = (rng.random((len(nodes), fanout)) * np.maximum(deg, 1)[:, None]).astype(np.int64)
    idx = np.minimum(start[:, None] + off, max(len(nbrs) - 1, 0))
    sampled = nbrs[idx] if len(nbrs) else np.zeros_like(idx)
    m = np.broadcast_to(valid[:, None], (len(nodes), fanout))
    return np.where(m, sampled, nodes[:, None]), m.copy()


def sample_block_fused(indptr: np.ndarray, nbrs: np.ndarray, seeds: np.ndarray,
                       seed_mask: np.ndarray, fanouts_innermost_first, seed: int,
                       lo: int = 0, hi: Optional[int] = None,
                       out_ids: Optional[np.ndarray] = None,
                       out_mask: Optional[np.ndarray] = None):
    """Every layer of a minibatch in one call, in the frontier-growth layout.

    ``fanouts_innermost_first`` is the order the frontier grows in, i.e.
    ``reversed(model_fanouts)``. Returns ``(ids int32 [n_final], mask uint8
    [n_final], sizes)``, where ``sizes[k]`` is the frontier length after k layers
    (``sizes[0] == len(seeds)``); layer k's block is a view of slices of ``ids`` and
    ``mask``. Neighbours outside ``[lo, hi)`` alias their destination with mask 0.
    Each row's generator is seeded from ``seed``, the layer and the row alone, so the
    draws are the same on every core count. ``out_ids``/``out_mask`` may be reused
    across batches. None where the library is missing.
    """
    lib = get_lib()
    if lib is None:
        return None
    b = len(seeds)
    fo = np.ascontiguousarray(list(fanouts_innermost_first), np.int64)
    sizes = [b]
    for f in fo:
        sizes.append(sizes[-1] * (1 + int(f)))
    n_final = sizes[-1]
    ids = (out_ids if out_ids is not None and len(out_ids) >= n_final
           else np.empty(n_final, np.int32))
    mask = (out_mask if out_mask is not None and len(out_mask) >= n_final
            else np.empty(n_final, np.uint8))
    ids[:b] = seeds
    mask[:b] = seed_mask
    lib.dgll_sample_block_fused(
        _p64(np.ascontiguousarray(indptr, np.int64)),
        _p64(np.ascontiguousarray(nbrs, np.int64)),
        _p64(fo), len(fo), b,
        int(lo), int(np.iinfo(np.int64).max if hi is None else hi),
        seed & 0xFFFFFFFFFFFFFFFF,
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _pu8(mask),
    )
    # views of exactly n_final entries, whatever the size of a reused buffer
    return ids[:n_final], mask[:n_final], sizes


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


def partition_pack(src, dst, w, rows: int, n_parts: int, e_shard: int):
    """Relabelled edges scattered into per-shard padded slabs, each edge at its
    arrival index within its shard (``dst // rows``): ``(S, D, W)`` of shape
    ``[n_parts, e_shard]`` (int32 source, int32 destination within the shard, float32
    weight; 0 in the padding), or None where the library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    w = np.ascontiguousarray(w, np.float32)
    S = np.zeros((n_parts, e_shard), np.int32)
    D = np.zeros((n_parts, e_shard), np.int32)
    W = np.zeros((n_parts, e_shard), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.dgll_partition_pack(
        _p64(src), _p64(dst), w.ctypes.data_as(f32p), len(src), rows, n_parts, e_shard,
        S.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        D.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), W.ctypes.data_as(f32p))
    return S, D, W


def build_csr_apply(dst, src, w, n_node: int):
    """The CSR build and its permutation in one multithreaded pass: ``(indptr int64
    [n_node + 1], src int32, dst int32, w float32 or None)``, the edges sorted by
    destination (stable within a destination). None where the library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    dst = np.ascontiguousarray(dst, np.int64)
    src = np.ascontiguousarray(src, np.int64)
    e = len(dst)
    indptr = np.empty(n_node + 1, np.int64)
    src_out = np.empty(e, np.int32)
    dst_out = np.empty(e, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    w_out = None
    wp = wop = ctypes.cast(None, fp)
    if w is not None:
        w = np.ascontiguousarray(w, np.float32)
        w_out = np.empty(e, np.float32)
        wp, wop = w.ctypes.data_as(fp), w_out.ctypes.data_as(fp)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.dgll_build_csr_apply(_p64(dst), _p64(src), wp, e, n_node, _p64(indptr),
                             src_out.ctypes.data_as(i32p), dst_out.ctypes.data_as(i32p),
                             wop)
    return indptr, src_out, dst_out, w_out


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


def random_walks(indptr, nbrs, starts, walk_length: int, seed: int) -> np.ndarray:
    """Uniform walks ``[len(starts), walk_length]`` over the out-edge CSR ``(indptr,
    nbrs)``, each from its start; a node without out-edges repeats itself. The library
    seeds each worker's generator from ``seed`` and its chunk, so its walks depend on
    the core count; the numpy fallback (``_np_walks``) draws from
    ``default_rng(seed)``."""
    lib = get_lib()
    starts = np.ascontiguousarray(starts, np.int64)
    nw = len(starts)
    if lib is None:
        return _np_walks(indptr, nbrs, starts, walk_length, seed)
    walks = np.empty(nw * walk_length, np.int64)
    lib.dgll_random_walks(
        _p64(np.ascontiguousarray(indptr, np.int64)),
        _p64(np.ascontiguousarray(nbrs, np.int64)),
        _p64(starts), nw, walk_length, seed & 0xFFFFFFFFFFFFFFFF, _p64(walks),
    )
    return walks.reshape(nw, walk_length)


def _np_walks(indptr, nbrs, starts, L, seed):
    rng = np.random.default_rng(seed)
    cur = starts.copy()
    walks = np.empty((len(cur), L), np.int64)
    walks[:, 0] = cur
    for t in range(1, L):
        deg = indptr[cur + 1] - indptr[cur]
        off = (rng.random(len(cur)) * np.maximum(deg, 1)).astype(np.int64)
        nxt = nbrs[np.minimum(indptr[cur] + off, max(len(nbrs) - 1, 0))] if len(nbrs) else cur
        cur = np.where(deg > 0, nxt, cur)
        walks[:, t] = cur
    return walks


def sort_rows(indptr: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """A copy of ``vals`` (int64) with each CSR row ``indptr[v]:indptr[v + 1]`` sorted,
    multithreaded; a numpy loop where the library is missing."""
    vals = np.ascontiguousarray(vals, np.int64).copy()
    lib = get_lib()
    n = len(indptr) - 1
    if lib is None:
        for v in range(n):
            lo, hi = indptr[v], indptr[v + 1]
            vals[lo:hi] = np.sort(vals[lo:hi])
        return vals
    lib.dgll_sort_rows(_p64(np.ascontiguousarray(indptr, np.int64)), n, _p64(vals))
    return vals


def node2vec_walks_native(indptr, nbrs_sorted, starts, walk_length: int, p: float,
                          q: float, seed: int) -> Optional[np.ndarray]:
    """node2vec's biased walks ``[len(starts), walk_length]`` over an out-edge CSR whose
    rows are sorted (``sort_rows``), by rejection in the library; None where the
    library is missing (the caller then runs its numpy loop)."""
    lib = get_lib()
    if lib is None:
        return None
    starts = np.ascontiguousarray(starts, np.int64)
    nw = len(starts)
    walks = np.empty(nw * walk_length, np.int64)
    lib.dgll_node2vec_walks(
        _p64(np.ascontiguousarray(indptr, np.int64)),
        _p64(np.ascontiguousarray(nbrs_sorted, np.int64)),
        _p64(starts), nw, walk_length, p, q, seed & 0xFFFFFFFFFFFFFFFF, _p64(walks),
    )
    return walks.reshape(nw, walk_length)
