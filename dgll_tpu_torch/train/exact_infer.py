"""Exact (full-neighbourhood) inference for minibatch-trained models.

Counterpart of ``dgll_tpu/train/exact_infer.py``. Every model's ``forward`` takes a
full ``Graph`` for all its layers, so exact inference is one full-graph forward with
the minibatch-trained parameters, under ``torch.no_grad()`` and in eval mode: each
layer aggregates over the complete in-neighbourhood, with no sampling noise.

On a CUDA device a GCN, GIN or GAT layer runs its kernels (K1; K3-K7 for GAT),
which read the chunked layouts: they are attached to the graph first where it lacks
them (``Graph.with_chunked``). GraphSAGE's mean and sum run K1 too, on layouts
built from the graph's edges on the device (``Graph.mean_chunked``); its max is plain PyTorch on every device, as the JAX package computes it in XLA.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _uses_kernels(model: torch.nn.Module) -> bool:
    from dgll_tpu_torch.nn.conv import GATConv, GCNConv, GINConv

    return any(isinstance(m, (GCNConv, GATConv, GINConv)) for m in model.modules())


def exact_logits(model: torch.nn.Module, graph, feats: torch.Tensor,
                 feat_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Log-probabilities ``[n_node, C]`` of one full-graph forward on ``feats``'s
    device, the graph moved there without its features, labels and masks.
    ``feat_dtype`` (the model's compute type, e.g. bfloat16) casts the features
    first, as the JAX package does: GraphSAGE and GIN aggregate them before their
    first ``Dense`` casts."""
    dev = feats.device
    if feat_dtype is not None:
        feats = feats.to(feat_dtype)
    g = graph.replace(node_feat=None, labels=None, train_mask=None, val_mask=None,
                      test_mask=None)
    if dev.type != "cpu" and g.chunked is None and _uses_kernels(model):
        g = g.with_chunked()
    g = g.to(dev)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(g, feats)
    finally:
        model.train(was_training)


def exact_predict(model: torch.nn.Module, graph, feats: torch.Tensor,
                  nodes: Optional[np.ndarray] = None,
                  feat_dtype: Optional[torch.dtype] = None) -> np.ndarray:
    """Argmax class of each node of ``nodes`` (default: every real node) by the
    exact full-graph forward, as an int32 numpy array."""
    logp = exact_logits(model, graph, feats, feat_dtype)
    pred = logp.argmax(-1).to(torch.int32).cpu().numpy()[: graph.n_real_node]
    if nodes is None:
        return pred
    return pred[np.asarray(nodes, np.int64)]


def exact_accuracy(model: torch.nn.Module, graph, feats: torch.Tensor, labels_np,
                   nodes, feat_dtype: Optional[torch.dtype] = None) -> float:
    """Accuracy over ``nodes`` through exact inference."""
    nodes = np.asarray(nodes, np.int64)
    if len(nodes) == 0:
        return 0.0
    pred = exact_predict(model, graph, feats, nodes, feat_dtype)
    return float((pred == np.asarray(labels_np)[nodes]).mean())
