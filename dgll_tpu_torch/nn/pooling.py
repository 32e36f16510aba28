"""Global graph pooling and graph batching.

Counterpart of ``dgll_tpu/nn/pooling.py``: sum, mean and max pooling as segment
reductions over a ``graph_id`` vector, ``Pooling`` to concatenate several, and
``batch_graphs``, which merges many small graphs into one padded graph.

Padded nodes carry ``graph_id == n_graph``. The JAX package's segment ops drop an
out-of-range id silently; the port's ``segment_sum`` is an ``index_add``, which
refuses one, so the poolers drop those rows explicitly: they reduce into
``n_graph + 1`` segments, every id at or past ``n_graph`` sent to the last, and keep
the first ``n_graph``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dgll_tpu_torch.graph import Graph, pad_graph
from dgll_tpu_torch.ops.segment import segment_max, segment_mean, segment_sum


def _pool(reduce, x: torch.Tensor, graph_id: torch.Tensor, n_graph: int) -> torch.Tensor:
    ids = torch.clamp(graph_id, max=n_graph)  # padded rows to one extra segment
    return reduce(x, ids, n_graph + 1)[:n_graph]


def sum_pooling(x: torch.Tensor, graph_id: torch.Tensor, n_graph: int) -> torch.Tensor:
    """Per-graph sum."""
    return _pool(segment_sum, x, graph_id, n_graph)


def mean_pooling(x: torch.Tensor, graph_id: torch.Tensor, n_graph: int) -> torch.Tensor:
    """Per-graph mean (0 for a graph without nodes)."""
    return _pool(segment_mean, x, graph_id, n_graph)


def max_pooling(x: torch.Tensor, graph_id: torch.Tensor, n_graph: int) -> torch.Tensor:
    """Per-graph max (0 for a graph without nodes)."""
    return _pool(segment_max, x, graph_id, n_graph)


_POOLERS = {"sum": sum_pooling, "mean": mean_pooling, "max": max_pooling}


class Pooling(nn.Module):
    """One global pooler, or several concatenated feature-wise (``kinds``)."""

    def __init__(self, kinds: Tuple[str, ...] = ("sum",)):
        super().__init__()
        unknown = set(kinds) - set(_POOLERS)
        if unknown:
            raise ValueError(f"unknown pooling {sorted(unknown)}")
        self.kinds = tuple(kinds)

    def forward(self, x: torch.Tensor, graph_id: torch.Tensor, n_graph: int) -> torch.Tensor:
        outs = [_POOLERS[k](x, graph_id, n_graph) for k in self.kinds]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def batch_graphs(graphs: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, int]],
                 node_pad_multiple: int = 8, edge_pad_multiple: int = 128):
    """Merge ``(src, dst, feats, label)`` tuples into one padded ``Graph`` on the
    host: ``(graph, graph_id int32 [n_node], labels int32 [n_graph])``, padded nodes
    with ``graph_id == n_graph``. On a CUDA device, attach the kernel layouts
    (``Graph.with_chunked``) before moving the graph there."""
    srcs, dsts, feats, gids, labels = [], [], [], [], []
    off = 0
    for i, (s, d, f, y) in enumerate(graphs):
        srcs.append(np.asarray(s) + off)
        dsts.append(np.asarray(d) + off)
        feats.append(f)
        gids.append(np.full(f.shape[0], i, np.int32))
        labels.append(y)
        off += f.shape[0]
    g = Graph.from_edges(np.concatenate(srcs), np.concatenate(dsts), off,
                         node_feat=np.concatenate(feats, axis=0))
    g = pad_graph(g, node_pad_multiple, edge_pad_multiple)
    graph_id = np.full(g.n_node, len(graphs), np.int32)
    graph_id[:off] = np.concatenate(gids)
    return (g, torch.from_numpy(graph_id),
            torch.from_numpy(np.asarray(labels, np.int32)))
