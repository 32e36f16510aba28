"""Layer-wise importance samplers on the host: FastGCN and LADIES (+ flat / WRS).

Counterpart of ``dgll_tpu/sampling/layerwise.py``, numpy and scipy in the same order
of operations, so that one ``np.random.default_rng(seed)`` gives the same blocks in
both packages, bit for bit.

* FastGCN: layer-independent probabilities ``p_i ∝ ||L[:, i]||^2`` over the whole
  graph (computed once); each layer draws ``s`` nodes without replacement, slices
  ``Q = L[prev, :][:, drawn]`` and rescales the drawn-only columns by
  ``1 / (p_j * s)``.
* LADIES: layer-dependent ``p_j ∝ ||L[prev, :][:, j]||^2``, recomputed from the
  previous layer's rows.
* ``flatten``: ``p <- sqrt(p)``. ``wrs``: weighted sampling without replacement by
  Efraimidis-Spirakis exponential keys.
* ``geometric_layer_sizes``: ``n_samp * rate^l`` a layer.

Blocks are fixed-shape ``SparseBlock``s (padded node and edge counts), outermost
first, whose tensors are views of the sampler's numpy arrays.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from dgll_tpu_torch.sampling.base import BaseSampler, HostGraph, SparseBlock


def normalized_laplacian(g) -> sp.csr_matrix:
    """``D^-1/2 (A + I) D^-1/2`` over a ``Graph``'s real edges as scipy CSR; rows are
    destinations, self loops deduplicated."""
    src = g.src.cpu().numpy()[: g.n_real_edge]
    dst = g.dst.cpu().numpy()[: g.n_real_edge]
    n = g.n_real_node
    A = sp.coo_matrix((np.ones(len(src), np.float32), (dst, src)), shape=(n, n)).tocsr()
    A = A + sp.eye(n, dtype=np.float32, format="csr")
    A.data = np.minimum(A.data, 1.0)  # dedupe self loops
    d = np.asarray(A.sum(axis=1)).ravel()
    dinv = 1.0 / np.sqrt(np.maximum(d, 1.0))
    D = sp.diags(dinv.astype(np.float32))
    return (D @ A @ D).tocsr()


def geometric_layer_sizes(n_samp: int, growth_rate: float, n_layers: int) -> List[int]:
    """Per-layer sample counts ``n_samp * rate^l``, outermost (input side) first."""
    return [max(1, int(round(n_samp * growth_rate**l))) for l in range(n_layers)][::-1]


def _draw_without_replacement(p: np.ndarray, s: int, rng: np.random.Generator,
                              wrs: bool) -> np.ndarray:
    p = np.maximum(p, 0)
    tot = p.sum()
    if tot <= 0:
        p = np.ones_like(p)
        tot = p.sum()
    p = p / tot
    s = min(s, int((p > 0).sum()))
    if wrs:
        # Efraimidis-Spirakis: the top s of u^(1/p) are the top s of log(u)/p
        u = rng.random(p.shape[0])
        keys = np.where(p > 0, np.log(u) / np.maximum(p, 1e-30), -np.inf)
        return np.argpartition(-keys, s - 1)[:s]
    return rng.choice(p.shape[0], size=s, replace=False, p=p)


def _pad_ids(ids: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    out = np.zeros(n, np.int64)
    mask = np.zeros(n, bool)
    k = min(len(ids), n)
    out[:k] = ids[:k]
    mask[:k] = True
    return out, mask


class LayerWiseSampler(BaseSampler):
    """Shared machinery; subclasses define the per-layer probabilities.

    ``layer_sizes`` outermost first; ``edges_per_dst`` sizes a block's padded edge
    count (``n_dst * edges_per_dst``); ``include_seeds`` puts the previous layer's
    nodes at the head of every block's sources (the layer protocol)."""

    def __init__(self, lap: sp.csr_matrix, layer_sizes: Sequence[int],
                 flatten: bool = False, wrs: bool = False, edges_per_dst: int = 32,
                 include_seeds: bool = True, seed: int = 0):
        self.lap = lap.tocsr()
        self.lap_sq = self.lap.multiply(self.lap).tocsr()
        self.layer_sizes = [int(s) for s in layer_sizes]  # outermost first
        self.flatten = flatten
        self.wrs = wrs
        self.edges_per_dst = int(edges_per_dst)
        self.include_seeds = include_seeds
        self._rng = np.random.default_rng(seed)
        # a DataLoader's producers may call sample() at once; the draws of one
        # batch come from the generator in one piece
        self._lock = threading.Lock()

    def _layer_probs(self, prev_nodes: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def sample(self, g: Optional[HostGraph], seeds: np.ndarray,
               pad_to: Optional[int] = None
               ) -> Tuple[np.ndarray, np.ndarray, List[SparseBlock]]:
        """``(input_nodes, output_nodes, blocks)``, blocks outermost first. ``g`` is
        unused (the sampler holds the Laplacian); ``pad_to`` pads the seeds."""
        with self._lock:
            return self._sample(seeds, pad_to)

    def _sample(self, seeds, pad_to):
        seeds = np.asarray(seeds, np.int64)
        b = len(seeds) if pad_to is None else int(pad_to)
        out_ids, out_mask = _pad_ids(seeds, b)

        blocks: List[SparseBlock] = []
        prev_ids, prev_mask = out_ids, out_mask  # the dst side of the current layer
        # from the output layer down (innermost block first), then reversed
        for s in reversed(self.layer_sizes):
            prev_real = prev_ids[prev_mask]
            p = self._layer_probs(prev_real)
            if self.flatten:
                p = np.sqrt(p)
            cand = _draw_without_replacement(p, s, self._rng, self.wrs)
            if self.include_seeds:
                # the previous layer's (padded) dst ids at the head of src_ids, then
                # the drawn candidates not already present
                extra = np.setdiff1d(np.unique(cand), prev_real)
                b_prev = prev_ids.shape[0]
                src_ids = np.zeros(b_prev + s, np.int64)
                src_mask = np.zeros(b_prev + s, bool)
                src_ids[:b_prev] = prev_ids
                src_mask[:b_prev] = prev_mask
                k = min(len(extra), s)
                src_ids[b_prev: b_prev + k] = extra[:k]
                src_mask[b_prev: b_prev + k] = True
                self_at_head = True
            else:
                # a pure importance sample (unbiased estimator); no self guarantee
                src_ids, src_mask = _pad_ids(np.unique(cand), s)
                self_at_head = False

            # Q = L[prev, :][:, src]: drawn-only columns rescaled by 1/(p_j s), the
            # deterministically included previous-layer columns kept exact
            # (defensive importance sampling: unbiased, with bounded weights)
            real_src = src_ids[src_mask]
            pfull = p / max(p.sum(), 1e-30)
            Q = self.lap[prev_real][:, real_src].tocoo()
            scale = 1.0 / np.maximum(pfull[real_src[Q.col]] * s, 1e-12)
            if self.include_seeds:
                in_prev = np.isin(real_src[Q.col], prev_real)
                scale = np.where(in_prev, 1.0, scale)
            data = Q.data * scale
            src_pos = np.nonzero(src_mask)[0]  # local slot of each real src column

            blocks.insert(0, _pack_sparse_block(
                dst_ids=prev_ids, dst_mask=prev_mask, src_ids=src_ids,
                src_mask=src_mask, rows=np.nonzero(prev_mask)[0][Q.row],
                cols=src_pos[Q.col], vals=data.astype(np.float32),
                n_edge=prev_ids.shape[0] * self.edges_per_dst,
                self_at_head=self_at_head))
            prev_ids, prev_mask = src_ids, src_mask

        input_nodes = blocks[0].src_ids.numpy().astype(np.int64)
        return input_nodes, out_ids, blocks


def _pack_sparse_block(dst_ids, dst_mask, src_ids, src_mask, rows, cols, vals, n_edge,
                       self_at_head=True) -> SparseBlock:
    """A ``SparseBlock`` of ``n_edge`` padded edges; over the budget it keeps the
    heaviest ``n_edge`` (importance-weighted truncation)."""
    ne = len(vals)
    if ne > n_edge:
        keep = np.argpartition(-np.abs(vals), n_edge - 1)[:n_edge]
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
        ne = n_edge
    src_l = np.zeros(n_edge, np.int64)
    dst_l = np.zeros(n_edge, np.int64)
    w = np.zeros(n_edge, np.float32)
    src_l[:ne], dst_l[:ne], w[:ne] = cols, rows, vals
    return SparseBlock(
        dst_ids=torch.from_numpy(dst_ids.astype(np.int32)),
        src_ids=torch.from_numpy(src_ids.astype(np.int32)),
        src=torch.from_numpy(src_l.astype(np.int32)),
        dst=torch.from_numpy(dst_l.astype(np.int32)),
        edge_weight=torch.from_numpy(w),
        dst_mask=torch.from_numpy(dst_mask),
        src_mask=torch.from_numpy(src_mask),
        n_dst=int(dst_ids.shape[0]),
        n_src=int(src_ids.shape[0]),
        n_edge=int(n_edge),
        self_at_head=bool(self_at_head),
    )


class FastGCNSampler(LayerWiseSampler):
    """Layer-independent importance sampling: ``p_i ∝ ||L[:, i]||^2``."""

    def __init__(self, lap: sp.csr_matrix, layer_sizes, **kw):
        super().__init__(lap, layer_sizes, **kw)
        self._global_p = np.asarray(self.lap_sq.sum(axis=0)).ravel()  # ||L[:, i]||^2

    def _layer_probs(self, prev_nodes: np.ndarray) -> np.ndarray:
        return self._global_p.copy()


class LadiesSampler(LayerWiseSampler):
    """Layer-dependent importance sampling: ``p_j ∝ ||L[prev, :][:, j]||^2``."""

    def _layer_probs(self, prev_nodes: np.ndarray) -> np.ndarray:
        return np.asarray(self.lap_sq[prev_nodes].sum(axis=0)).ravel()
