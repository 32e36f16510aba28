"""Named datasets: their metric and a loader injected by the caller.

Counterpart of ``dgll_tpu/data/registry.py``. The named datasets (cora, citeseer,
pubmed, reddit, the OGB node sets, PPI) come from constructors that download them;
``load_dataset(name, loader=...)`` takes that constructor as a parameter, so nothing
here reaches the network and tests pass a mock.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from dgll_tpu_torch.graph import Graph

# name -> its evaluation metric and the kind of loader that builds it
DATASETS: Dict[str, dict] = {
    "cora": {"metric": "acc", "kind": "planetoid"},
    "citeseer": {"metric": "acc", "kind": "planetoid"},
    "pubmed": {"metric": "acc", "kind": "planetoid"},
    "reddit": {"metric": "f1", "kind": "dgl"},
    "ogbn-arxiv": {"metric": "acc", "kind": "ogb"},
    "ogbn-products": {"metric": "acc", "kind": "ogb"},
    "ogbn-proteins": {"metric": "roc-auc", "kind": "ogb"},
    "ppi": {"metric": "f1", "kind": "ppi"},
}


def load_dataset(
    name: str,
    loader: Optional[Callable] = None,
    add_self_loops: bool = True,
    make_bidirected: bool = True,
) -> Graph:
    """The ``Graph`` of a named dataset. ``loader()`` returns ``(src, dst, feats,
    labels, splits)``, ``splits`` a dict of ``train``/``valid``/``test`` index
    arrays; the edges are bidirected and get self-loops unless told otherwise."""
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(DATASETS)}")
    if loader is None:
        raise RuntimeError(
            f"dataset {name!r} needs a loader callable (nothing is downloaded here); "
            "pass loader=... returning (src, dst, feats, labels, splits)"
        )
    src, dst, feats, labels, splits = loader()
    n = feats.shape[0]
    masks = {}
    for k in ("train", "valid", "test"):
        m = np.zeros(n, bool)
        m[np.asarray(splits[k])] = True
        masks[k] = m
    return Graph.from_edges(
        src, dst, n,
        node_feat=np.asarray(feats, np.float32),
        labels=np.asarray(labels),
        train_mask=masks["train"],
        val_mask=masks["valid"],
        test_mask=masks["test"],
        add_self_loops=add_self_loops,
        make_bidirected=make_bidirected,
    )


def dataset_metric(name: str) -> str:
    """The evaluation metric of a named dataset."""
    return DATASETS[name]["metric"]
