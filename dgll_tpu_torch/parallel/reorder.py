"""Node reordering that gives the windowed SpMM layout its source locality.

Counterpart of ``dgll_tpu/parallel/reorder.py``. The windowed layout
(``ops/windowed.py``) needs a destination 128-row block's sources to fall into few
aligned 512-row windows. Clustered graphs have that in id space; others may have
the structure but not the ids. Relabelling recovers it:

* :func:`estimate_windowed_fraction`: the layout builder's group pre-filter alone,
  a cheap upper bound of the fraction it captures;
* orderings: ``community`` (label propagation, members contiguous:
  ``parallel/community.py``), ``rcm`` (reverse Cuthill-McKee over A + A^T, scipy),
  ``degree`` (out-degree descending);
* :func:`reorder_for_locality`: the ordering with the best estimate, or the graph
  as it was when none helps enough (an expander has no locality to find).

Training on the permuted graph is exact: features, labels and masks move with the
nodes, and ``Graph.node_perm`` maps new ids to the original ones.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dgll_tpu_torch.graph import Graph
from dgll_tpu_torch.ops.chunked import R_BLOCK
from dgll_tpu_torch.ops.windowed import SUB, WIN_ROWS


def _edges(g: Graph) -> Tuple[np.ndarray, np.ndarray]:
    e = g.n_real_edge
    return (g.src.cpu().numpy()[:e].astype(np.int64),
            g.dst.cpu().numpy()[:e].astype(np.int64))


def estimate_windowed_fraction(src: np.ndarray, dst: np.ndarray,
                               min_fill: float = 0.25) -> float:
    """The fraction of edges in (dst 128-block, src 512-window) groups of at least
    ``min_fill * SUB`` edges: ``build_windowed``'s vectorised pre-filter. The
    builder's sub-chunk cuts capture slightly less."""
    if len(src) == 0:
        return 1.0
    key = (np.asarray(dst, np.int64) // R_BLOCK) * (1 << 32) \
        + np.asarray(src, np.int64) // WIN_ROWS
    _, counts = np.unique(key, return_counts=True)
    big = counts >= max(min_fill * SUB, 1.0)
    return float(counts[big].sum() / len(src))


def degree_order(g: Graph) -> np.ndarray:
    """Out-degree descending (stable): hub sources pack into the first windows."""
    return np.argsort(-g.out_degrees_np()[: g.n_real_node], kind="stable")


def rcm_order(g: Graph) -> np.ndarray:
    """Reverse Cuthill-McKee over A + A^T: a narrow id band of sources per row."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    n = g.n_real_node
    s, d = _edges(g)
    a = sp.coo_matrix((np.ones(len(s), np.int8), (d, s)), shape=(n, n)).tocsr()
    return np.asarray(reverse_cuthill_mckee(a + a.T, symmetric_mode=True), np.int64)


def community_order(g: Graph, seed: int = 0) -> np.ndarray:
    """Label-propagation communities, members contiguous, communities in id order;
    communities below one window are merged first."""
    from dgll_tpu_torch.parallel.community import detect_communities, merge_groups

    part = detect_communities(g, seed=seed)
    part = merge_groups(part, min_size=min(WIN_ROWS, g.n_real_node))
    return np.argsort(part, kind="stable")


def permute_graph(g: Graph, order: np.ndarray) -> Graph:
    """Relabel so that new node ``i`` is old node ``order[i]``: edges (weights kept),
    features, labels and masks permuted; ``node_perm`` composed with any earlier
    reordering. The result holds the real nodes and edges only, with no layouts."""
    from dgll_tpu_torch import native

    n = g.n_real_node
    order = np.asarray(order, np.int64)
    new_id = np.empty(n, np.int64)
    new_id[order] = np.arange(n)
    s, d = _edges(g)
    ew = None if g.edge_weight is None else g.edge_weight.cpu().numpy()[: g.n_real_edge]

    def _perm(x):
        return None if x is None else x.cpu().numpy()[:n][order]

    g2 = Graph.from_edges(
        native.remap(new_id, s), native.remap(new_id, d), n, edge_weight=ew,
        node_feat=_perm(g.node_feat), labels=_perm(g.labels),
        train_mask=_perm(g.train_mask), val_mask=_perm(g.val_mask),
        test_mask=_perm(g.test_mask),
    )
    perm = order if g.node_perm is None else g.node_perm.cpu().numpy()[order]
    perm = torch.from_numpy(np.ascontiguousarray(perm, np.int64))
    return g2.replace(node_perm=perm).to(g.src.device)


def reorder_for_locality(
    g: Graph,
    methods: Sequence[str] = ("community", "rcm", "degree"),
    min_fill: float = 0.25,
    min_fraction: Optional[float] = None,
    early_stop_fraction: float = 0.85,
    seed: int = 0,
) -> Tuple[Graph, Dict[str, float]]:
    """Relabel by the ordering with the best capture estimate.

    Returns ``(graph, info)``, ``info`` holding each ordering's estimate and seconds.
    The graph comes back as it was when no ordering beats the identity by more than
    1e-3, or, with ``min_fraction`` set, when the best estimate stays below it
    (``info["declined"]``: the layout builder would decline anyway). Orderings run
    in turn and stop once one reaches ``early_stop_fraction``.
    """
    src, dst = _edges(g)
    t0 = time.perf_counter()
    base = estimate_windowed_fraction(src, dst, min_fill)
    info: Dict[str, float] = {"estimate_identity": base}

    best_name, best_frac, best_order = "identity", base, None
    orderings = {"community": lambda: community_order(g, seed=seed),
                 "rcm": lambda: rcm_order(g), "degree": lambda: degree_order(g)}
    for name in methods:
        if name not in orderings:
            raise ValueError(f"unknown reorder method {name!r}")
        t1 = time.perf_counter()
        order = orderings[name]()
        new_id = np.empty(g.n_real_node, np.int64)
        new_id[order] = np.arange(g.n_real_node)
        frac = estimate_windowed_fraction(new_id[src], new_id[dst], min_fill)
        info[f"estimate_{name}"] = frac
        info[f"order_{name}_s"] = time.perf_counter() - t1
        if frac > best_frac + 1e-3:
            best_name, best_frac, best_order = name, frac, order
        if best_frac >= early_stop_fraction:
            break

    info["chosen"] = best_name  # type: ignore[assignment]
    info["estimate_chosen"] = best_frac
    if min_fraction is not None and best_frac < min_fraction:
        info["chosen"] = "identity"  # type: ignore[assignment]
        info["declined"] = True  # type: ignore[assignment]
        info["total_s"] = time.perf_counter() - t0
        return g, info
    if best_order is not None:
        t1 = time.perf_counter()
        g = permute_graph(g, best_order)
        info["permute_s"] = time.perf_counter() - t1
    info["total_s"] = time.perf_counter() - t0
    return g, info
