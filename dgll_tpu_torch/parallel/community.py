"""COG, community-ordered graphs: detection, merging, contiguous relabelling.

Counterpart of ``dgll_tpu/parallel/community.py``, all host numpy:

* :func:`detect_communities`: label propagation, through the shared C++ kernel
  (``native.label_propagation``) or its numpy fallback;
* :func:`max_community_size`: the capacity model (device-memory budget over the
  per-node feature and label bytes);
* :func:`merge_groups`, :func:`split_oversized`: community sizes within bounds;
* :func:`relabel_communities`: each community a contiguous id range;
* :func:`run_cog`: the whole pipeline;
* :func:`save_community_book`, :func:`load_community_book`,
  :func:`community_feature_slice`: the community book and its feature slices.

Community-contiguous ids concentrate a row block's sources into few windows, which
is the locality the windowed SpMM layout needs (``parallel/reorder.py``).
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Tuple

import numpy as np

from dgll_tpu_torch.graph import Graph


def detect_communities(g: Graph, max_iters: int = 20, seed: int = 0) -> np.ndarray:
    """Label propagation over the real edges: a community id per real node.

    The C++ kernel is asynchronous and multithreaded (one thread under 16,384
    nodes); the numpy fallback updates a random half of the nodes per synchronous
    sweep, drawn from ``seed``, so that two-colourings cannot oscillate.
    """
    from dgll_tpu_torch import native

    n = g.n_real_node
    indptr = g.indptr.cpu().numpy()[: n + 1].astype(np.int64).copy()
    indptr[-1] = min(indptr[-1], g.n_real_edge)
    nbrs = g.src.cpu().numpy()[: g.n_real_edge].astype(np.int64)
    labels = np.arange(n, dtype=np.int64)

    if not native.label_propagation(indptr, nbrs, n, max_iters, labels):
        rng = np.random.default_rng(seed)
        dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        for _ in range(2 * max_iters):
            lab = labels[nbrs]
            key = dst * (n + 1) + lab
            uniq, cnt = np.unique(key, return_counts=True)
            du, lu = uniq // (n + 1), uniq % (n + 1)
            order = np.lexsort((lu, -cnt, du))
            du_s, lu_s = du[order], lu[order]
            first = np.searchsorted(du_s, np.arange(n))
            safe = np.minimum(first, max(len(du_s) - 1, 0))
            valid = (first < len(du_s)) & (du_s[safe] == np.arange(n))
            best = np.where(valid, lu_s[safe], labels)
            if (best == labels).all():
                break  # no node wants to change, not only this sweep's half
            labels = np.where(rng.random(n) < 0.5, best, labels)
    _, comp = np.unique(labels, return_inverse=True)
    return comp


def max_community_size(hbm_budget_bytes: int, feat_dim: int, feat_bytes: int = 4,
                       label_bytes: int = 4) -> int:
    """Largest community whose features and labels fit the budget."""
    per_node = feat_dim * feat_bytes + label_bytes
    return max(1, int(hbm_budget_bytes // per_node))


def merge_groups(part_of: np.ndarray, min_size: int) -> np.ndarray:
    """Merge communities smaller than ``min_size``.

    Communities sorted by ascending size are binned by the prefix sum of their sizes
    (``min_size`` per bin); a fold over the bins then closes a bin only once it has
    reached ``min_size``, and an undersized remainder joins the last bin.
    """
    ids, sizes = np.unique(part_of, return_counts=True)
    if len(ids) <= 1:
        _, comp = np.unique(part_of, return_inverse=True)
        return comp
    order = np.argsort(sizes, kind="stable")
    prefix = np.cumsum(sizes[order]) - sizes[order]
    gid_sorted = (prefix // max(min_size, 1)).astype(np.int64)
    _, gid_sorted = np.unique(gid_sorted, return_inverse=True)
    n_bins = int(gid_sorted.max()) + 1
    bin_sizes = np.bincount(gid_sorted, weights=sizes[order].astype(np.float64),
                            minlength=n_bins).astype(np.int64)
    fold = np.empty(n_bins, np.int64)
    cur, acc = 0, 0
    for b in range(n_bins):
        fold[b] = cur
        acc += int(bin_sizes[b])
        if acc >= min_size:
            cur += 1
            acc = 0
    if acc > 0 and cur > 0:
        fold[fold == cur] = cur - 1
    gid = np.empty(len(ids), np.int64)
    gid[order] = fold[gid_sorted]
    _, comp = np.unique(gid[np.searchsorted(ids, part_of)], return_inverse=True)
    return comp


def split_oversized(part_of: np.ndarray, max_size: int) -> np.ndarray:
    """Split communities above ``max_size`` into pieces of ``max_size``, in member
    order."""
    part_of = part_of.copy()
    nxt = int(part_of.max()) + 1
    for cid in np.unique(part_of):
        members = np.nonzero(part_of == cid)[0]
        for i in range(max_size, len(members), max_size):
            part_of[members[i: i + max_size]] = nxt
            nxt += 1
    _, comp = np.unique(part_of, return_inverse=True)
    return comp


def relabel_communities(g: Graph, part_of: np.ndarray) -> Tuple[Graph, Dict]:
    """Relabel so each community is a contiguous id range; returns the permuted
    graph and the community book ``{cid: [start, end)}``."""
    from dgll_tpu_torch.parallel.reorder import permute_graph

    order = np.argsort(part_of, kind="stable")
    ids, counts = np.unique(part_of, return_counts=True)
    starts = np.r_[0, np.cumsum(counts)]
    book = {int(c): [int(starts[i]), int(starts[i + 1])] for i, c in enumerate(ids)}
    return permute_graph(g, order), book


def run_cog(g: Graph, hbm_budget_bytes: int = 1 << 30, batch_size: int = 1024,
            seed: int = 0) -> Tuple[Graph, Dict, Dict[str, float]]:
    """Detect, merge the small, split the oversized, relabel. Returns the permuted
    graph, the community book and the seconds of each phase."""
    timings: Dict[str, float] = {}
    t0 = time.perf_counter()
    part = detect_communities(g, seed=seed)
    timings["detect"] = time.perf_counter() - t0

    feat_dim = 0 if g.node_feat is None else int(g.node_feat.shape[1])
    cap = max_community_size(hbm_budget_bytes, max(feat_dim, 1))
    t0 = time.perf_counter()
    part = merge_groups(part, min_size=min(batch_size, g.n_real_node))
    part = split_oversized(part, max_size=cap)
    timings["merge_split"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    g2, book = relabel_communities(g, part)
    timings["relabel"] = time.perf_counter() - t0
    return g2, book, timings


def save_community_book(book: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump({str(k): v for k, v in book.items()}, f)


def load_community_book(path: str) -> Dict[int, List[int]]:
    with open(path) as f:
        return {int(k): v for k, v in json.load(f).items()}


def community_feature_slice(features, book: Dict, cid: int):
    """The contiguous feature rows of community ``cid``."""
    lo, hi = book[cid]
    return features[lo:hi]
