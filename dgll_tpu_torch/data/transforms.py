"""Graph and feature normalisation, and offline neighbour-feature aggregation.

Counterpart of ``dgll_tpu/data/transforms.py``: the symmetric GCN normalisation
``D^-1/2 (A+I) D^-1/2``, the random-walk normalisation ``D^-1 A``, row-normalised
features and the precomputed neighbour mean or sum of ``--preprocess``, each in torch
on the graph's (or the features') device.

The edge weightings that ``Graph.chunked_pair`` builds K1's layouts over are here too
(``edge_weights``): the graph's own, the mean's and GCN's, each rule written once.
"""
from __future__ import annotations

from typing import Optional

import torch

from dgll_tpu_torch.graph import Graph
from dgll_tpu_torch.ops.spmm import spmm_coo


def gcn_weights(g: Graph, require_self_loops: bool = True) -> torch.Tensor:
    """The weights of ``D^-1/2 (A [+ I]) D^-1/2`` on every edge of ``g``, ``[n_edge]``
    float32 on the graph's device: ``dinv[dst] * dinv[src]`` on the real edges, the
    degrees counted over them in float64, and 0 on padded edges. With
    ``require_self_loops`` a real node without its self-loop raises."""
    e = g.n_real_edge
    src, dst = g.src.long(), g.dst.long()
    if require_self_loops:
        has_loop = torch.zeros(g.n_node, dtype=torch.bool, device=dst.device)
        has_loop[dst[:e][src[:e] == dst[:e]]] = True
        if not bool(has_loop[: g.n_real_node].all()):
            raise ValueError("GCN's normalisation D^-1/2 (A + I) D^-1/2 on a graph without "
                             "self-loops: build with Graph.from_edges(..., "
                             "add_self_loops=True) so shapes stay static")
    deg = torch.bincount(dst[:e], minlength=g.n_node).double()  # exact past 2^24
    dinv = 1.0 / torch.sqrt(deg.clamp_min(1.0))
    return torch.where(g.edge_mask, dinv[dst] * dinv[src], 0.0).float()


def gcn_normalize(g: Graph, add_self_loops: bool = True) -> Graph:
    """Set edge weights to the symmetric GCN normalisation D^-1/2 (A [+ I]) D^-1/2
    (``gcn_weights``; ``add_self_loops`` requires the loops to be there already)."""
    return g.replace(edge_weight=gcn_weights(g, require_self_loops=add_self_loops))


def edge_weights(g: Graph, weighting: str) -> Optional[torch.Tensor]:
    """The weights of ``weighting`` on every edge of ``g``, padded ones included:
    ``"edges"`` the graph's own (None: 1 on each); ``"mean"`` ``1 / max(deg(dst), 1)``,
    the in-degree read from ``indptr`` (the neighbour mean); ``"gcn"`` ``gcn_weights``
    (no edge weight of the graph read: GCN's P is the model's)."""
    if weighting == "edges":
        return g.edge_weight
    if weighting == "mean":
        return torch.reciprocal(g.in_degrees.clamp_min(1).float())[g.dst.long()]
    if weighting == "gcn":
        return gcn_weights(g)
    raise ValueError(f"unknown edge weighting {weighting!r}: 'edges', 'mean' or 'gcn'")


def _in_degrees(g: Graph) -> torch.Tensor:
    """In-degree of every node over the real edges, float32 on the graph's device."""
    dst = g.dst[: g.n_real_edge].long()
    return torch.bincount(dst, minlength=g.n_node).to(torch.float32)


def row_normalize_adj(g: Graph) -> Graph:
    """Set edge weights to D^-1 A (random-walk normalisation); padded edges keep
    weight 0."""
    real = torch.arange(g.n_edge, device=g.dst.device) < g.n_real_edge
    inv = 1.0 / _in_degrees(g).clamp_min(1.0)
    w = torch.where(real, inv[g.dst.long()], 0.0)
    return g.replace(edge_weight=w)


def row_normalize_features(x) -> torch.Tensor:
    """Each row divided by its sum (ref ``dgll/nn/utils/utils.py:240-249``), float32."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return x / x.sum(dim=1, keepdim=True).clamp_min(1e-12)


def precompute_neighbor_features(g: Graph, kind: str = "mean") -> torch.Tensor:
    """Offline neighbour-feature aggregation, the reference's ``preprocess`` mode
    (``FeatureCache/gs.py:43-56``: a precomputed neighbour field replaces the
    outermost sampled hop, so training samples one hop fewer a batch).

    Returns the ``[n_real_node, d]`` mean (``kind="mean"``) or sum of each real
    node's in-neighbours' features over the real edges, float32 on the graph's
    device; the caller concatenates it with the raw features and drops the outermost
    fanout. The sums run in another order than the JAX package's ``np.add.at``, so
    the two agree to float32 rounding.
    """
    if kind not in ("mean", "sum"):
        raise ValueError(f"unknown aggregation {kind!r}")
    n = g.n_real_node
    x = g.node_feat[:n].to(torch.float32)
    agg = spmm_coo(g.src[: g.n_real_edge], g.dst[: g.n_real_edge], x, n)
    if kind == "mean":
        agg = agg / _in_degrees(g)[:n].clamp_min(1.0)[:, None]
    return agg
