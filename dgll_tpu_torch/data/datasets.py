"""Dataset loaders and synthetic graph generators.

Counterpart of ``dgll_tpu/data/datasets.py``, on numpy and torch:

* the synthetic generators (``synthetic_classification_graph``,
  ``synthetic_power_law_graph``, ``synthetic_graph_classification``), pure numpy
  drawing in the same order, so one seed gives the same data in both packages;
* the planetoid/cora ``.content`` + ``.cites`` text format (``load_planetoid``);
* a PPI split, ``{split}_graph.json`` (networkx node-link) with ``.npy`` features,
  labels and graph ids (``load_ppi_split``);
* the graph-classification text format (``load_dataP``, ``S2VGraph``);
* pickled graphs (``save_graph``/``load_graph``): a dict of numpy arrays, the same
  file in both packages, so a graph saved by either loads in the other.
"""
from __future__ import annotations

import json
import os
import pickle
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from dgll_tpu_torch.data.transforms import row_normalize_features
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


def synthetic_power_law_graph(
    n_node: int, avg_degree: int, alpha: float = 1.0, seed: int = 0, feat_dim: int = 0
) -> Graph:
    """Raw power-law graph for kernel benchmarks: destinations drawn with
    probability ∝ (rank+1)^-alpha, uniform sources, no labels; ``feat_dim`` > 0 adds
    standard normal features."""
    rng = np.random.default_rng(seed)
    n_edge = n_node * avg_degree
    p = (np.arange(n_node, dtype=np.float64) + 1.0) ** (-alpha)
    p /= p.sum()
    dst = rng.choice(n_node, size=n_edge, p=p)
    src = rng.integers(0, n_node, size=n_edge)
    feats = (
        rng.normal(0, 1, size=(n_node, feat_dim)).astype(np.float32) if feat_dim else None
    )
    return Graph.from_edges(src, dst, n_node, node_feat=feats)


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


# ---------------------------------------------------- graph classification text
@dataclass
class S2VGraph:
    """One graph of the GIN text format (the reference's ``S2VGraph``): a bidirected
    edge list, per-node tags (or degrees), optional float node attributes, an integer
    label."""

    src: np.ndarray                  # [e] int64, bidirected
    dst: np.ndarray                  # [e] int64
    node_tags: List[int]
    label: int
    n_node: int
    node_features: Optional[np.ndarray] = None   # [n, d] float32 (attributes or one-hot tags)
    neighbors: Optional[List[List[int]]] = None
    max_neighbor: int = 0


def load_dataP(path: str, degree_as_tag: bool = False) -> Tuple[List[S2VGraph], int]:
    """Parse the graph-classification text format: the first line is the number of
    graphs; each graph a header ``n label`` and ``n`` node rows ``tag deg nbr_0 ...
    nbr_{deg-1} [attr ...]`` (float attributes on all rows or none). Labels and tags
    are renumbered densely in first-seen order; ``degree_as_tag`` replaces the tags
    by degrees. Nodes without attributes get one-hot tag features. Returns
    ``(graphs, n_classes)``."""
    g_list: List[S2VGraph] = []
    label_dict: dict = {}
    feat_dict: dict = {}

    with open(path) as f:
        n_g = int(f.readline().strip())
        for _ in range(n_g):
            n, lab = (int(w) for w in f.readline().strip().split())
            if lab not in label_dict:
                label_dict[lab] = len(label_dict)
            tags: List[int] = []
            attrs: List[np.ndarray] = []
            src, dst = [], []
            for j in range(n):
                row = f.readline().strip().split()
                deg = int(row[1])
                head = [int(w) for w in row[: deg + 2]]
                if len(row) > deg + 2:
                    attrs.append(np.array([float(w) for w in row[deg + 2:]]))
                if head[0] not in feat_dict:
                    feat_dict[head[0]] = len(feat_dict)
                tags.append(feat_dict[head[0]])
                for k in head[2:]:
                    src.append(j)
                    dst.append(k)
            if attrs and len(attrs) != n:
                raise ValueError(
                    f"graph with {n} nodes has float attrs on only {len(attrs)} "
                    "node rows — the format requires all or none"
                )
            # undirected pairs deduplicated, then both directions
            und = sorted({(min(a, b), max(a, b)) for a, b in zip(src, dst)})
            u = [a for a, _ in und]
            v = [b for _, b in und]
            neighbors: List[List[int]] = [[] for _ in range(n)]
            for a, b in und:
                neighbors[a].append(b)
                neighbors[b].append(a)
            g_list.append(S2VGraph(
                src=np.array(u + v, np.int64),
                dst=np.array(v + u, np.int64),
                node_tags=tags,
                label=label_dict[lab],
                n_node=n,
                node_features=np.stack(attrs).astype(np.float32) if attrs else None,
                neighbors=neighbors,
                max_neighbor=max((len(x) for x in neighbors), default=0),
            ))

    if degree_as_tag:
        degset: dict = {}
        for g in g_list:
            degs = [len(x) for x in g.neighbors]
            for dg in degs:
                if dg not in degset:
                    degset[dg] = len(degset)
            g.node_tags = [degset[dg] for dg in degs]
        n_tag = len(degset)
    else:
        n_tag = len(feat_dict)

    for g in g_list:
        if g.node_features is None:
            oh = np.zeros((g.n_node, n_tag), np.float32)
            oh[np.arange(g.n_node), np.asarray(g.node_tags)] = 1.0
            g.node_features = oh
    return g_list, len(label_dict)


def s2v_to_tuples(g_list: List[S2VGraph]):
    """``(src, dst, feats, label)`` tuples for ``dgll_tpu_torch.nn.batch_graphs``."""
    return [(g.src, g.dst, g.node_features, g.label) for g in g_list]


def separate_graphs(graph_list: List[S2VGraph], seed: int, fold_idx: int,
                    n_splits: int = 10) -> Tuple[List[S2VGraph], List[S2VGraph]]:
    """Stratified k-fold split of graphs by label (``data.utils.separate_data``):
    ``(train, test)``."""
    from dgll_tpu_torch.data.utils import separate_data

    train_idx, test_idx = separate_data(
        [g.label for g in graph_list], n_folds=n_splits, fold_idx=fold_idx, seed=seed
    )
    return [graph_list[i] for i in train_idx], [graph_list[i] for i in test_idx]


# ------------------------------------------------------------------ planetoid
def load_planetoid(path: str, dataset: str = "cora") -> Graph:
    """Load ``<path>/<dataset>.content`` and ``.cites``: content rows are ``<id>
    <feat...> <label>``, cites rows ``<cited> <citing>``. Features are
    row-normalised, labels numbered in sorted order, edges bidirected with
    self-loops; the planetoid splits (140 train, 500 validation, 1000 test)."""
    content = np.genfromtxt(os.path.join(path, f"{dataset}.content"), dtype=np.dtype(str))
    ids = content[:, 0]
    feats = row_normalize_features(content[:, 1:-1].astype(np.float32)).numpy()
    label_strs = content[:, -1]
    classes = sorted(set(label_strs))
    labels = np.array([classes.index(c) for c in label_strs], np.int32)

    idx_map = {j: i for i, j in enumerate(ids)}
    cites = np.genfromtxt(os.path.join(path, f"{dataset}.cites"), dtype=np.dtype(str))
    cites = cites.reshape(-1, 2)  # a single-edge file parses as 1-D
    edges = np.array(
        [(idx_map[a], idx_map[b]) for a, b in cites if a in idx_map and b in idx_map],
        np.int64,
    ).reshape(-1, 2)
    n = len(ids)
    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    train_mask[:140] = True
    val_mask[200:700] = True
    test_mask[500:1500] = True
    return Graph.from_edges(
        edges[:, 0], edges[:, 1], n, node_feat=feats, labels=labels,
        train_mask=train_mask, val_mask=val_mask, test_mask=test_mask,
        make_bidirected=True, add_self_loops=True,
    )


# ------------------------------------------------------------------------ PPI
def load_ppi_split(path: str, split: str = "train") -> List[Graph]:
    """Load a PPI split: ``{split}_graph.json`` (a networkx node-link dump of every
    graph of the split) and ``{split}_feats.npy``, ``_labels.npy`` and
    ``_graph_id.npy``. One ``Graph`` a graph id (its nodes a contiguous id range),
    with multilabel float32 targets, bidirected with self-loops."""
    with open(os.path.join(path, f"{split}_graph.json")) as f:
        gdata = json.load(f)
    feats = np.load(os.path.join(path, f"{split}_feats.npy"))
    labels = np.load(os.path.join(path, f"{split}_labels.npy"))
    graph_id = np.load(os.path.join(path, f"{split}_graph_id.npy"))

    links = np.array([(lk["source"], lk["target"]) for lk in gdata["links"]],
                     np.int64).reshape(-1, 2)
    graphs = []
    for gid in np.unique(graph_id):
        nodes = np.nonzero(graph_id == gid)[0]
        lo, hi = nodes.min(), nodes.max()
        m = (links[:, 0] >= lo) & (links[:, 0] <= hi)
        e = links[m] - lo
        graphs.append(Graph.from_edges(
            e[:, 0], e[:, 1], hi - lo + 1,
            node_feat=feats[lo: hi + 1].astype(np.float32),
            labels=labels[lo: hi + 1].astype(np.float32),
            make_bidirected=True, add_self_loops=True,
        ))
    return graphs


# ------------------------------------------------------------- pickled graphs
def _host(t) -> Optional[np.ndarray]:
    return None if t is None else t.detach().cpu().numpy()


def save_graph(g: Graph, path: str) -> None:
    """Write ``g`` as a pickle of numpy arrays: edges, real node count, edge
    weights, features, labels and masks (the JAX package's file format)."""
    state = {
        "src": _host(g.src),
        "dst": _host(g.dst),
        "n_node": g.n_real_node,
        "edge_weight": _host(g.edge_weight),
        "node_feat": _host(g.node_feat),
        "labels": _host(g.labels),
        "train_mask": _host(g.train_mask),
        "val_mask": _host(g.val_mask),
        "test_mask": _host(g.test_mask),
    }
    with open(path, "wb") as f:
        pickle.dump(state, f)


def load_graph(path: str) -> Graph:
    """A graph ``save_graph`` wrote, in this package or the JAX one."""
    with open(path, "rb") as f:
        s = pickle.load(f)
    return Graph.from_edges(
        s["src"], s["dst"], s["n_node"], edge_weight=s["edge_weight"],
        node_feat=s["node_feat"], labels=s["labels"], train_mask=s["train_mask"],
        val_mask=s["val_mask"], test_mask=s["test_mask"],
    )
