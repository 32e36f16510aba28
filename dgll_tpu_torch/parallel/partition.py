"""Graph partitioning for the graph-partition-parallel path: counterpart of
``dgll_tpu/parallel/partition.py``.

Nodes are relabelled so that each shard owns a contiguous range of ids (its feature
rows are one dense slice), and each shard's in-edges are padded to one count, so that
every rank's shard has the same shapes. Host numpy, run once; the arrays equal the
JAX package's element for element (the BFS seeds' ``default_rng`` draws included).

Strategies: ``contiguous`` (degree-balanced: hubs dealt round-robin), ``bfs``
(locality-greedy growth from a random unassigned node, METIS-flavoured without the
dependency) and ``range`` (the id order kept: shard ``id // rows``, for ids that are
already locality-ordered, e.g. COG-relabelled).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np

from dgll_tpu_torch import native


@dataclass
class PartitionedGraph:
    """Per-shard dst-major edge lists stacked on a leading shard axis (host numpy).

    Shard ``k`` owns destination nodes ``[k * rows, (k + 1) * rows)`` after the
    relabelling. ``src`` holds global (relabelled) source ids, ``dst_local`` the
    destination's offset within the shard; padded edge slots point at row 0 with
    weight 0. Node arrays are in the relabelled order, ``n_shard * rows`` long.
    """

    src: np.ndarray          # [n_shard, e_shard] int32 global source ids
    dst_local: np.ndarray    # [n_shard, e_shard] int32 local destination offsets
    edge_weight: np.ndarray  # [n_shard, e_shard] float32 (0 = padding)
    node_feat: Optional[np.ndarray] = None
    labels: Optional[np.ndarray] = None
    train_mask: Optional[np.ndarray] = None
    val_mask: Optional[np.ndarray] = None
    test_mask: Optional[np.ndarray] = None
    perm: Optional[np.ndarray] = None       # [n_real_node] int32, old id -> new id
    n_shard: int = 1
    rows_per_shard: int = 0
    e_shard: int = 0
    n_real_node: int = 0

    @property
    def n_node(self) -> int:
        return self.n_shard * self.rows_per_shard


def _np(t) -> Optional[np.ndarray]:
    return None if t is None else t.cpu().numpy()


def _contiguous_assignment(g, n_parts: int) -> np.ndarray:
    """Balanced parts over a degree-aware node order (hubs spread round-robin)."""
    deg = _np(g.in_degrees)[: g.n_real_node]
    order = np.argsort(-deg, kind="stable")
    part_of = np.zeros(g.n_real_node, np.int32)
    part_of[order] = np.arange(g.n_real_node) % n_parts
    return part_of


def _bfs_grow_assignment(g, n_parts: int, seed: int = 0) -> np.ndarray:
    """Locality-greedy BFS growth: each part grows from a random unassigned node up
    to ``ceil(n / n_parts)`` nodes; leftovers go to the smallest part."""
    n = g.n_real_node
    indptr = _np(g.indptr)[: n + 1]
    src = _np(g.src)[: g.n_real_edge]
    target = -(-n // n_parts)
    part_of = np.full(n, -1, np.int32)
    rng = np.random.default_rng(seed)
    sizes = np.zeros(n_parts, np.int64)
    for p in range(n_parts):
        unass = np.nonzero(part_of < 0)[0]
        if unass.size == 0:
            break
        q = deque([int(rng.choice(unass))])
        while q and sizes[p] < target:
            v = q.popleft()
            if part_of[v] >= 0:
                continue
            part_of[v] = p
            sizes[p] += 1
            for u in src[indptr[v]: indptr[v + 1]]:
                if part_of[u] < 0:
                    q.append(int(u))
    for v in np.nonzero(part_of < 0)[0]:
        part_of[v] = int(np.argmin(sizes))
        sizes[part_of[v]] += 1
    return part_of


def _pack(src, dst, w, rows: int, n_parts: int, e_shard: int, counts):
    """``native.partition_pack``, or its numpy counterpart (a counting sort by shard,
    each edge at its arrival index, then one flat scatter)."""
    packed = native.partition_pack(src, dst, w, rows, n_parts, e_shard)
    if packed is not None:
        return packed
    shard = dst // rows
    within = np.empty(len(shard), np.int64)
    for p in range(n_parts):
        m = shard == p
        within[m] = np.arange(int(counts[p]), dtype=np.int64)
    flat = shard * e_shard + within
    S = np.zeros(n_parts * e_shard, np.int32)
    D = np.zeros(n_parts * e_shard, np.int32)
    W = np.zeros(n_parts * e_shard, np.float32)
    S[flat] = src
    D[flat] = dst - shard * rows
    W[flat] = w
    return tuple(a.reshape(n_parts, e_shard) for a in (S, D, W))


def partition_graph(g, n_parts: int, strategy: str = "contiguous",
                    edge_multiple: int = 128, seed: int = 0) -> PartitionedGraph:
    """Partition ``g``'s destinations into ``n_parts`` shards of ``ceil(n / n_parts)``
    relabelled rows each; each shard's edges padded to a multiple of
    ``edge_multiple``."""
    n = g.n_real_node
    if strategy == "contiguous":
        part_of = _contiguous_assignment(g, n_parts)
    elif strategy == "bfs":
        part_of = _bfs_grow_assignment(g, n_parts, seed)
    elif strategy == "range":
        part_of = (np.arange(n) // -(-n // n_parts)).astype(np.int32)
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    # new id = part * rows + rank within the part (stable order)
    rows = -(-n // n_parts)
    order = np.argsort(part_of, kind="stable")
    sorted_parts = part_of[order].astype(np.int64)
    starts = np.searchsorted(sorted_parts, np.arange(n_parts))
    within = np.arange(n, dtype=np.int64) - starts[sorted_parts]
    new_id = np.empty(n, np.int64)
    new_id[order] = sorted_parts * rows + within

    src = native.remap(new_id, _np(g.src)[: g.n_real_edge])
    dst = native.remap(new_id, _np(g.dst)[: g.n_real_edge])
    w = (_np(g.edge_weight)[: g.n_real_edge] if g.edge_weight is not None
         else np.ones(g.n_real_edge, np.float32))
    counts = np.bincount(dst // rows, minlength=n_parts)
    e_shard = int(counts.max()) if len(counts) else 0
    e_shard = -(-e_shard // edge_multiple) * edge_multiple
    S, D, W = _pack(src, dst, w, rows, n_parts, e_shard, counts)

    def reorder(x):
        if x is None:
            return None
        xp = _np(x)[:n]
        out = np.zeros((n_parts * rows,) + xp.shape[1:], xp.dtype)
        out[new_id] = xp
        return out

    return PartitionedGraph(
        src=S, dst_local=D, edge_weight=W,
        node_feat=reorder(g.node_feat), labels=reorder(g.labels),
        train_mask=reorder(g.train_mask), val_mask=reorder(g.val_mask),
        test_mask=reorder(g.test_mask), perm=new_id.astype(np.int32),
        n_shard=n_parts, rows_per_shard=rows, e_shard=e_shard, n_real_node=n)
