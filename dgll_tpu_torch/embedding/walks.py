"""Random-walk generators: DeepWalk, node2vec, struc2vec. Counterpart of
``dgll_tpu/embedding/walks.py``, the same host numpy: for the same seed the walks are
equal, bit for bit.

Parity with the reference ``ge`` package (``Graph Embedding/src/ge/``):

* DeepWalk uniform walks        — ``deepWalk.py:24-39``
* node2vec p/q-biased walks     — ``node2vec.py:36-118``, implemented here with
  vectorised rejection sampling (the scalable equivalent of computing per-step
  transition probabilities on the fly).
* struc2vec structural walks    — ``struc2vec.py`` / ``biasedRandomWalk.py``: degree-
  sequence DTW similarity layers; compact implementation (opt1-style: degree-based
  cost, k-nearest structural neighbours) suitable for the reference's graph sizes.

All walk generation is host-side vectorised numpy (and the host library of
``native.py``) over an out-edge CSR — the CPU producer role; the skip-gram consumer,
on the device, lives in ``skipgram.py``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from dgll_tpu_torch import native
from dgll_tpu_torch.graph import Graph


class WalkGraph:
    """Out-edge CSR view for walking (the transpose of the message-passing CSR)."""

    def __init__(self, indptr: np.ndarray, nbrs: np.ndarray, n_node: int):
        self.indptr = indptr
        self.nbrs = nbrs
        self.n_node = n_node
        self.degrees = np.diff(indptr)

    @staticmethod
    def from_graph(g: Graph) -> "WalkGraph":
        src = g.src[: g.n_real_edge].cpu().numpy()
        dst = g.dst[: g.n_real_edge].cpu().numpy()
        order = np.argsort(src, kind="stable")
        s, d = src[order], dst[order]
        indptr = np.zeros(g.n_real_node + 1, np.int64)
        np.add.at(indptr, s + 1, 1)
        indptr = np.cumsum(indptr)
        # sort neighbours within each row for O(log d) membership tests (node2vec);
        # multithreaded C++ row sort (falls back to a numpy loop)
        nbrs = native.sort_rows(indptr, d)
        return WalkGraph(indptr, nbrs, g.n_real_node)

    def has_edge(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Vectorised membership test u->v over sorted adjacency."""
        lo = self.indptr[u]
        hi = self.indptr[u + 1]
        pos = np.empty_like(u)
        for i in range(len(u)):  # searchsorted per row segment
            s = self.nbrs[lo[i] : hi[i]]
            j = np.searchsorted(s, v[i])
            pos[i] = 1 if (j < len(s) and s[j] == v[i]) else 0
        return pos.astype(bool)

    def sample_neighbor(self, nodes: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        deg = self.degrees[nodes]
        off = (rng.random(len(nodes)) * np.maximum(deg, 1)).astype(np.int64)
        nxt = self.nbrs[np.minimum(self.indptr[nodes] + off, len(self.nbrs) - 1)]
        return np.where(deg > 0, nxt, nodes)


def deepwalk_walks(
    wg: WalkGraph, num_walks: int, walk_length: int, seed: int = 0,
    nodes: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Uniform random walks [num_walks * n_start, walk_length] (ref ``RandomWalk:24``).

    Zero-degree nodes self-loop (the reference truncates; fixed length keeps downstream
    shapes static — self-loop contexts are neutral for skip-gram).
    """
    starts = np.arange(wg.n_node) if nodes is None else np.asarray(nodes)
    cur = np.tile(starts, num_walks)
    return native.random_walks(wg.indptr, wg.nbrs, cur, walk_length, seed)


def node2vec_walks(
    wg: WalkGraph, num_walks: int, walk_length: int, p: float = 1.0, q: float = 1.0,
    seed: int = 0, nodes: Optional[np.ndarray] = None, max_reject: int = 8,
) -> np.ndarray:
    """2nd-order biased walks via vectorised rejection sampling (ref ``node2vec.py``).

    Proposal: uniform neighbour of the current node; acceptance weight 1/p for a
    return step, 1 for a triangle step (candidate adjacent to the previous node),
    1/q otherwise. ``max_reject`` rounds bound the loop; leftover rejections fall
    back to the last proposal (bias negligible for moderate p/q).
    """
    starts = np.arange(wg.n_node) if nodes is None else np.asarray(nodes)
    cur = np.tile(starts, num_walks)
    nat = native.node2vec_walks_native(wg.indptr, wg.nbrs, cur, walk_length, p, q, seed)
    if nat is not None:
        return nat

    rng = np.random.default_rng(seed)
    prev = cur.copy()
    walks = np.empty((len(cur), walk_length), np.int64)
    walks[:, 0] = cur
    wmax = max(1.0 / p, 1.0, 1.0 / q)
    for t in range(1, walk_length):
        cand = wg.sample_neighbor(cur, rng)
        undecided = np.ones(len(cur), bool)
        for _ in range(max_reject):
            if not undecided.any():
                break
            u = np.nonzero(undecided)[0]
            w = np.where(
                cand[u] == prev[u], 1.0 / p,
                np.where(wg.has_edge(prev[u], cand[u]), 1.0, 1.0 / q),
            )
            accept = rng.random(len(u)) < (w / wmax)
            undecided[u[accept]] = False
            stay = u[~accept]
            if len(stay):
                cand[stay] = wg.sample_neighbor(cur[stay], rng)
        prev, cur = cur, cand
        walks[:, t] = cur
    return walks


# ------------------------------------------------------------------ struc2vec
def _degree_rings(wg: WalkGraph, k_hops: int) -> list:
    """Sorted degree sequence of each node's ring at hops 0..k (BFS, host)."""
    rings = []
    for v in range(wg.n_node):
        seen = {v}
        frontier = [v]
        per_hop = []
        for _ in range(k_hops + 1):
            per_hop.append(np.sort(wg.degrees[frontier]))
            nxt = []
            for u in frontier:
                for w in wg.nbrs[wg.indptr[u] : wg.indptr[u + 1]]:
                    if w not in seen:
                        seen.add(w)
                        nxt.append(w)
            frontier = nxt
            if not frontier:
                break
        rings.append(per_hop)
    return rings


def _dtw(a: np.ndarray, b: np.ndarray) -> float:
    """DTW with the struc2vec degree cost max/min - 1 (ref ``utils.py`` cost fns)."""
    na, nb = len(a), len(b)
    if na == 0 or nb == 0:
        return 0.0 if na == nb else float(max(na, nb))
    D = np.full((na + 1, nb + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, na + 1):
        for j in range(1, nb + 1):
            cost = max(a[i - 1], b[j - 1]) / max(min(a[i - 1], b[j - 1]), 1) - 1.0
            D[i, j] = cost + min(D[i - 1, j], D[i, j - 1], D[i - 1, j - 1])
    return float(D[na, nb])


def struc2vec_walks(
    wg: WalkGraph, num_walks: int, walk_length: int, k_hops: int = 2,
    n_similar: int = 10, stay_prob: float = 0.3, seed: int = 0,
) -> np.ndarray:
    """Multilayer struc2vec biased walks (ref ``struc2vec.py`` full machinery,
    with the opt1 similar-degree candidate reduction).

    Construction, as in the reference:

    * ordered degree lists per hop ring (``_compute_ordered_degreelist``);
    * layered **cumulative** DTW distances ``d_k(u,v) = d_{k-1} + dtw(ring_k)``
      over the opt1 candidate set (nearest nodes in the degree ordering);
    * per-layer similarity weights ``w_k(u, v) = exp(-d_k(u, v))``
      (``_get_layer_rep``);
    * layer-transition probabilities from the reference's gamma statistic
      (``_get_transition_probs`` / ``prepare_biased_walk``): ``gamma_k(v)`` counts
      structural neighbours whose weight beats the layer average, and
      ``p_up = gamma / (gamma + 1)``.

    The walk itself (``BiasedWalker``): with prob ``stay_prob`` jump to a
    structural neighbour of the current layer (weight-proportional — the exact
    distribution the reference's alias tables sample); otherwise move up with
    ``p_up`` / down with ``1 - p_up``, clipped to the layer range.
    """
    rng = np.random.default_rng(seed)
    rings = _degree_rings(wg, k_hops)
    n = wg.n_node

    # candidate structural neighbours: nearest by degree (opt1 reduction)
    deg = wg.degrees
    order = np.argsort(deg, kind="stable")
    pos_of = np.empty(n, np.int64)
    pos_of[order] = np.arange(n)

    sim_nbrs = np.zeros((n, n_similar), np.int64)
    sim_w = np.zeros((n, n_similar, k_hops + 1), np.float32)
    for v in range(n):
        lo = max(0, pos_of[v] - n_similar)
        cands = [c for c in order[lo : pos_of[v] + n_similar + 1] if c != v][:n_similar]
        cands += [v] * (n_similar - len(cands))
        sim_nbrs[v] = cands
        for ci, c in enumerate(cands):
            d = 0.0
            for h in range(k_hops + 1):
                ra = rings[v][h] if h < len(rings[v]) else np.array([])
                rb = rings[c][h] if h < len(rings[c]) else np.array([])
                d += _dtw(ra, rb)
                sim_w[v, ci, h] = np.exp(-d)

    # layer-average weights and gamma (count of above-average structural
    # neighbours) -> p_up per (node, layer), ref _get_transition_probs
    avg_w = sim_w.reshape(-1, k_hops + 1).mean(axis=0)            # [L]
    gamma = (sim_w > avg_w[None, None, :]).sum(axis=1)            # [n, L]
    p_up = gamma / (gamma + 1.0)                                   # [n, L]

    starts = np.arange(n)
    cur = np.tile(starts, num_walks)
    lay = np.zeros(len(cur), np.int64)
    walks = np.empty((len(cur), walk_length), np.int64)
    walks[:, 0] = cur
    for t in range(1, walk_length):
        stay = rng.random(len(cur)) < stay_prob
        # layer move (ref BiasedWalker: up with p_up, down otherwise)
        up = rng.random(len(cur)) < p_up[cur, lay]
        lay = np.where(stay, lay, np.clip(lay + np.where(up, 1, -1), 0, k_hops))
        # in-layer structural jump, weight-proportional
        w = sim_w[cur, :, lay]  # [B, n_similar]
        w = w / np.maximum(w.sum(1, keepdims=True), 1e-12)
        cdf = np.cumsum(w, axis=1)
        pick = (rng.random(len(cur))[:, None] < cdf).argmax(1)
        cur = sim_nbrs[cur, pick]
        walks[:, t] = cur
    return walks
