"""Host data utilities. Counterpart of ``dgll_tpu/data/utils.py``:

* ``multihop_sampling``: fixed-fanout multi-hop id expansion (with replacement),
  one id array a hop, for code that wants ids rather than blocks;
* ``create_khop_index``: a dense ``[n_node, max_neighbors]`` table of sampled
  neighbours;
* ``separate_data``: a stratified k-fold split for graph classification.

The draws are ``native.sample_neighbors``', seeded from ``seed`` as in the JAX
package.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from dgll_tpu_torch import native
from dgll_tpu_torch.sampling.base import HostGraph


def multihop_sampling(
    hg: HostGraph, seeds: Sequence[int], fanouts: Sequence[int], seed: int = 0
) -> List[np.ndarray]:
    """``[seeds, hop 1 ids, hop 2 ids, ...]``, hop k of ``len(hop k-1) * fanout_k``
    ids."""
    rng = np.random.default_rng(seed)
    out = [np.asarray(seeds, np.int64)]
    for k in fanouts:
        prev = out[-1]
        sampled, _ = native.sample_neighbors(
            hg.indptr, hg.src, prev, np.ones(len(prev), bool), k,
            int(rng.integers(0, 2**63 - 1)),
        )
        out.append(sampled.reshape(-1))
    return out


def create_khop_index(
    hg: HostGraph, k: int, max_neighbors: int, seed: int = 0
) -> np.ndarray:
    """``[n_node, max_neighbors]`` sampled neighbours of every node (with
    replacement), drawn from ``seed``. ``k`` is kept for the JAX signature: the JAX
    function's ``k`` one-neighbour walks do not reach its result."""
    full, _ = native.sample_neighbors(
        hg.indptr, hg.src, np.arange(hg.n_node), np.ones(hg.n_node, bool),
        max_neighbors, seed,
    )
    return full


def separate_data(
    labels: Sequence[int], n_folds: int = 10, fold_idx: int = 0, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Stratified k-fold ``(train_idx, test_idx)``: each class's members shuffled
    and dealt round-robin to the folds; fold ``fold_idx`` is the test set."""
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    folds: List[List[int]] = [[] for _ in range(n_folds)]
    for c in np.unique(labels):
        members = np.nonzero(labels == c)[0]
        rng.shuffle(members)
        for i, m in enumerate(members):
            folds[i % n_folds].append(int(m))
    test = np.asarray(sorted(folds[fold_idx % n_folds]), np.int64)
    train = np.asarray(sorted(set(range(len(labels))) - set(test)), np.int64)
    return train, test
