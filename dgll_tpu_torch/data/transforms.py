"""Graph and feature normalisation, and offline neighbour-feature aggregation.

Counterpart of ``dgll_tpu/data/transforms.py``: the symmetric GCN normalisation
``D^-1/2 (A+I) D^-1/2`` (host numpy, at load time), the random-walk normalisation
``D^-1 A``, row-normalised features and the precomputed neighbour mean or sum of
``--preprocess``, each in torch on the graph's (or the features') device.
"""
from __future__ import annotations

import numpy as np
import torch

from dgll_tpu_torch.graph import Graph
from dgll_tpu_torch.ops.spmm import spmm_coo


def gcn_normalize(g: Graph, add_self_loops: bool = True) -> Graph:
    """Set edge weights to the symmetric GCN normalisation D^-1/2 (A [+ I]) D^-1/2.

    Degrees count only real edges; padded edges keep weight 0. Host-side (numpy),
    run once at load time.
    """
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    real = np.arange(g.n_edge) < g.n_real_edge

    if add_self_loops:
        has_loop = np.zeros(g.n_node, bool)
        has_loop[dst[real & (src == dst)]] = True
        if not has_loop[: g.n_real_node].all():
            raise ValueError(
                "gcn_normalize(add_self_loops=True) on a graph without self-loops: "
                "build with Graph.from_edges(..., add_self_loops=True) so shapes stay static."
            )

    deg = np.zeros(g.n_node, np.float64)
    np.add.at(deg, dst[real], 1.0)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    w = np.where(real, dinv[dst] * dinv[src], 0.0).astype(np.float32)
    return g.replace(edge_weight=torch.from_numpy(w).to(g.src.device))


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
