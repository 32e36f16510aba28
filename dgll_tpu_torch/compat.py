"""Reference-API compatibility surface: counterpart of ``dgll_tpu/compat.py``.

One import site mapping every public name a dke-lab/dgll user knows onto this
port's equivalents, so switching is a search-and-replace of the package name. Names
and call shapes follow the reference; semantics are the port's (static shapes,
host/device split) documented on each target. ``backend`` is ``torch``, as the
reference's is.

    from dgll_tpu_torch import compat as dgll
    g = dgll.DGraph(nodes, edges, labels, features, train, test, validation)
    sampler = dgll.DGLLNeighborSampler([10, 5])
    loader = dgll.DataLoader(g, train_nodes, sampler, batch_size)
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# --- backend shim: the reference exposes `from dgll import backend as F`
#     (dgll/__init__.py:1 — literally torch), as does the port.
import torch as backend  # noqa: F401

from dgll_tpu_torch.graph import Graph
from dgll_tpu_torch.sampling import (  # noqa: F401
    BaseSampler as Base_sampler,
    Block as sugbraph,  # the reference's (typo'd) block class, base_sampler.py:65
    DGLLNeighborSampler,
    FastGCNSampler,
    LadiesSampler,
    NeighborSampler,
)
from dgll_tpu_torch.dataloader import DataLoader  # noqa: F401
from dgll_tpu_torch.nn import (  # noqa: F401
    GAT,
    GCN,
    GIN,
    GraphSAGE,
    Pooling,
)
from dgll_tpu_torch.nn.conv import GATConv as gatConv  # noqa: F401
from dgll_tpu_torch.nn.conv import GCNConv as gcnConv  # noqa: F401
from dgll_tpu_torch.nn.conv import GCNConv as GraphConvolution  # dup layer, gcn.py:17
from dgll_tpu_torch.nn.conv import GINConv as GinConv  # noqa: F401
from dgll_tpu_torch.nn.conv import SAGEConv as sageConv  # noqa: F401
from dgll_tpu_torch.nn.conv import GATConv as sparseGatConv  # sparse/dense unified
from dgll_tpu_torch.nn.models import GAT as SpGAT  # noqa: F401
from dgll_tpu_torch.nn.models import GraphSAGE as GraphSage  # reference spelling
from dgll_tpu_torch.nn.pooling import max_pooling as maxPooling  # noqa: F401
from dgll_tpu_torch.nn.pooling import mean_pooling as meanPooling  # noqa: F401
from dgll_tpu_torch.nn.pooling import sum_pooling as sumPooling  # noqa: F401
from dgll_tpu_torch.cache import HBMFeatureCache as GraphCacheServer  # noqa: F401
from dgll_tpu_torch.embedding import (  # noqa: F401
    DeepWalk,
    Node2Vec as Node2vec,
    SkipGramModel,
    Struc2Vec,
    train_all_classifiers as TrainingClassifiers,
)
from dgll_tpu_torch.data.datasets import S2VGraph, load_dataP  # noqa: F401 (utils.py:267-385)
from dgll_tpu_torch.data.datasets import load_graph as loadGraph  # noqa: F401
from dgll_tpu_torch.data.datasets import save_graph as saveGraph  # noqa: F401
from dgll_tpu_torch.data.datasets import separate_graphs as separate_data  # noqa: F401
from dgll_tpu_torch.data.utils import multihop_sampling  # noqa: F401 (utils.py:62)
from dgll_tpu_torch.embedding.skipgram import save_embedding as saveEmbedding  # noqa: F401
from dgll_tpu_torch.utils.logging import get_logger  # mylog.get_logger parity
from dgll_tpu_torch.data.transforms import row_normalize_features as normalize  # noqa: F401
from dgll_tpu_torch.train.metrics import accuracy  # noqa: F401


def DGraph(
    nodes: Sequence[int],
    edges: Dict[int, Sequence[int]],
    labels=None,
    features=None,
    train_mask=None,
    test_mask=None,
    validation_mask=None,
) -> Graph:
    """Construct a Graph from the reference ``DGraph`` signature
    (``dgll/data/dgraph.py:18-47``: adjacency-list dict ``edges[node] -> [nbrs]``).

    The result exposes the DGraph method surface (``get_neighbors``,
    ``get_induced_subgraph``, ``get_features``, ``get_labels``,
    ``get_train/validation/test_nodes``) as Graph methods.
    """
    n = len(nodes)
    src, dst = [], []
    for v, nbrs in edges.items():
        for u in nbrs:
            # reference stores out-neighbour lists; message flow u <- v neighbours
            src.append(u)
            dst.append(v)
    return Graph.from_edges(
        np.asarray(src, np.int64) if src else np.zeros(0, np.int64),
        np.asarray(dst, np.int64) if dst else np.zeros(0, np.int64),
        n,
        node_feat=features,
        labels=labels,
        train_mask=train_mask,
        val_mask=validation_mask,
        test_mask=test_mask,
    )


class mylog:
    """Namespace parity for ``from dgll... import mylog``."""

    get_logger = staticmethod(get_logger)
