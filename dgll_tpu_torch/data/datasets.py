"""Synthetic node- and graph-classification data.

Counterpart of ``dgll_tpu/data/datasets.py:synthetic_classification_graph`` and
``synthetic_graph_classification``. The generators are pure numpy and draw in the
same order, so one seed gives the same data in both packages.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from dgll_tpu_torch.graph import Graph


def synthetic_classification_graph(
    n_node: int = 2708,
    avg_degree: int = 4,
    n_class: int = 7,
    feat_dim: int = 64,
    power_law: float = 0.0,
    homophily: float = 0.8,
    seed: int = 0,
    train_frac: float = 0.1,
    val_frac: float = 0.2,
    feat_noise: float = 1.0,
) -> Graph:
    """SBM-flavoured node-classification graph with class-informative features.

    ``power_law > 0`` skews the destination degrees (prob ∝ (rank+1)^-power_law).
    Edges are bidirected and every node gets a self-loop.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_class, size=n_node)

    n_edge = n_node * avg_degree
    if power_law > 0:
        p = (np.arange(n_node, dtype=np.float64) + 1.0) ** (-power_law)
        p /= p.sum()
        dst = rng.choice(n_node, size=n_edge, p=p)
    else:
        dst = rng.integers(0, n_node, size=n_edge)

    # homophilous wiring: with prob `homophily` pick src from the same class
    same = rng.random(n_edge) < homophily
    order = np.argsort(labels, kind="stable")
    sorted_labels = labels[order]
    class_start = np.searchsorted(sorted_labels, np.arange(n_class))
    class_end = np.searchsorted(sorted_labels, np.arange(n_class), side="right")
    cls = labels[dst]
    lo, hi = class_start[cls], class_end[cls]
    same_src = order[(lo + (rng.random(n_edge) * np.maximum(hi - lo, 1)).astype(np.int64)) % n_node]
    rand_src = rng.integers(0, n_node, size=n_edge)
    src = np.where(same, same_src, rand_src)

    # class-mean features + noise
    means = rng.normal(0, 1, size=(n_class, feat_dim))
    feats = means[labels] + feat_noise * rng.normal(0, 1, size=(n_node, feat_dim))

    perm = rng.permutation(n_node)
    n_tr = int(train_frac * n_node)
    n_va = int(val_frac * n_node)
    train_mask = np.zeros(n_node, bool)
    val_mask = np.zeros(n_node, bool)
    test_mask = np.zeros(n_node, bool)
    train_mask[perm[:n_tr]] = True
    val_mask[perm[n_tr : n_tr + n_va]] = True
    test_mask[perm[n_tr + n_va :]] = True

    return Graph.from_edges(
        src,
        dst,
        n_node,
        node_feat=feats.astype(np.float32),
        labels=labels.astype(np.int32),
        train_mask=train_mask,
        val_mask=val_mask,
        test_mask=test_mask,
        make_bidirected=True,
        add_self_loops=True,
    )


def synthetic_graph_classification(
    n_graph: int = 128,
    n_node_range: Tuple[int, int] = (10, 40),
    n_class: int = 2,
    feat_dim: int = 8,
    seed: int = 0,
):
    """A list of ``(src, dst, feats, label)`` small graphs whose label sets their
    edge density (a learnable task); feature 0 is a scaled degree. Host numpy; batch
    them with ``dgll_tpu_torch.nn.batch_graphs``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graph):
        n = int(rng.integers(*n_node_range))
        label = int(rng.integers(0, n_class))
        p = 0.15 + 0.5 * label / max(n_class - 1, 1)  # density tied to the label
        m = np.maximum((rng.random((n, n)) < p), np.eye(n, dtype=bool))
        src, dst = np.nonzero(m)
        feats = rng.normal(0, 1, size=(n, feat_dim)).astype(np.float32)
        feats[:, 0] = 0.1 * (m.sum(0) - 1)  # degree feature
        out.append((src.astype(np.int64), dst.astype(np.int64), feats, label))
    return out
