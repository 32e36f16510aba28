"""Graph normalisation: symmetric GCN normalisation ``D^-1/2 (A+I) D^-1/2``.

Counterpart of ``dgll_tpu/data/transforms.py:gcn_normalize``.
"""
from __future__ import annotations

import numpy as np
import torch

from dgll_tpu_torch.graph import Graph


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
