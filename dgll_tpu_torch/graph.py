"""Graph container: COO + dst-major CSR as torch tensors.

Counterpart of ``dgll_tpu/graph.py``. The conventions are the same:

* Edges are stored sorted by **destination** node ("dst-major CSR"):
  ``indptr[i]:indptr[i+1]`` spans the in-edges of node ``i`` and ``src[k]`` is the
  neighbour the message comes from.
* Graphs may be padded (``pad_graph``): padded edges are self-loops on a padded node
  and carry zero weight; ``n_real_node`` / ``n_real_edge`` record the true counts.
* Features, labels and split masks ride along as optional tensors.

Construction is host-side: a graph is built on the CPU and moved once with
``Graph.to(device)``. Its kernel layouts (``with_chunked``, ``mean_chunked``,
``sum_chunked``) are built on the device the graph is on.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch


def _tensor(x, dtype=None) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@dataclass
class Graph:
    """Static-shape graph: COO + dst-major CSR, features, labels, split masks."""

    # CSR over destinations: in-edges of node i are slots indptr[i]:indptr[i+1].
    indptr: torch.Tensor                       # [n_node + 1] int32
    src: torch.Tensor                          # [n_edge] int32, CSR order
    dst: torch.Tensor                          # [n_edge] int32, non-decreasing
    edge_weight: Optional[torch.Tensor] = None  # [n_edge] float32

    node_feat: Optional[torch.Tensor] = None   # [n_node, d]
    labels: Optional[torch.Tensor] = None      # [n_node] or [n_node, c]
    train_mask: Optional[torch.Tensor] = None  # [n_node] bool
    val_mask: Optional[torch.Tensor] = None    # [n_node] bool
    test_mask: Optional[torch.Tensor] = None   # [n_node] bool

    # Kernel layouts (ops/chunked.py), attached by ``with_chunked``.
    chunked: Optional[Any] = None     # ChunkedCSR of A (dst-major)
    chunked_t: Optional[Any] = None   # ChunkedCSR of A^T (drives backward)
    # Windowed layouts (ops/windowed.py), attached by ``with_windowed``.
    hybrid: Optional[Any] = None      # HybridCSR of A (windowed + residual)
    hybrid_t: Optional[Any] = None    # HybridCSR of A^T
    # Set when the graph was relabelled for locality (parallel/reorder.py):
    # node_perm[new_id] == original id. Features, labels and masks are permuted
    # with the nodes, so training needs no mapping; per-node outputs in the original
    # id space are out[argsort(node_perm)].
    node_perm: Optional[torch.Tensor] = None   # [n_real_node] int64

    n_node: int = 0
    n_edge: int = 0
    n_real_node: int = 0
    n_real_edge: int = 0

    @staticmethod
    def from_edges(
        src: Any,
        dst: Any,
        n_node: int,
        edge_weight: Any = None,
        node_feat: Any = None,
        labels: Any = None,
        train_mask: Any = None,
        val_mask: Any = None,
        test_mask: Any = None,
        add_self_loops: bool = False,
        make_bidirected: bool = False,
    ) -> "Graph":
        """Build a Graph from a COO edge list (host-side; sorts by dst, builds indptr)."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if edge_weight is not None:
            edge_weight = np.asarray(edge_weight, dtype=np.float32)

        if make_bidirected:
            s2 = np.concatenate([src, dst])
            d2 = np.concatenate([dst, src])
            # dedupe (also removes duplicate input edges)
            _, keep = np.unique(s2 * n_node + d2, return_index=True)
            src, dst = s2[keep], d2[keep]
            if edge_weight is not None:
                edge_weight = np.concatenate([edge_weight, edge_weight])[keep]
        if add_self_loops:
            has_loop = np.zeros(n_node, bool)
            has_loop[dst[src == dst]] = True
            loop = np.nonzero(~has_loop)[0].astype(np.int64)
            src = np.concatenate([src, loop])
            dst = np.concatenate([dst, loop])
            if edge_weight is not None:
                edge_weight = np.concatenate(
                    [edge_weight, np.ones(loop.shape[0], np.float32)]
                )

        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        if edge_weight is not None:
            edge_weight = edge_weight[order]
        indptr = np.zeros(n_node + 1, np.int64)
        np.cumsum(np.bincount(dst, minlength=n_node), out=indptr[1:])

        n_edge = src.shape[0]
        return Graph(
            indptr=_tensor(indptr, torch.int32),
            src=_tensor(src, torch.int32),
            dst=_tensor(dst, torch.int32),
            edge_weight=_tensor(edge_weight, torch.float32),
            node_feat=_tensor(node_feat),
            labels=_tensor(labels),
            train_mask=_tensor(train_mask, torch.bool),
            val_mask=_tensor(val_mask, torch.bool),
            test_mask=_tensor(test_mask, torch.bool),
            n_node=int(n_node),
            n_edge=int(n_edge),
            n_real_node=int(n_node),
            n_real_edge=int(n_edge),
        )

    def replace(self, **changes) -> "Graph":
        return dataclasses.replace(self, **changes)

    def with_chunked(self) -> "Graph":
        """Attach the SpMM kernel layouts (A and A^T) built from the real edges and
        the current edge weights, on the graph's device. Layers then route
        weighted-sum aggregation through the kernel (``ops/cuda/segment_matmul.py``)."""
        from dgll_tpu_torch.ops.chunked import build_chunked_pair

        e = self.n_real_edge
        w = None if self.edge_weight is None else self.edge_weight[:e]
        c, ct = build_chunked_pair(self.src[:e], self.dst[:e], self.n_real_node,
                                   self.n_real_node, w)
        return self.replace(chunked=c, chunked_t=ct)

    @functools.cached_property
    def mean_chunked(self) -> tuple:
        """The SpMM kernel layouts ``(A, A^T)`` of SAGE's mean: every edge, padded
        ones included, weighed ``1 / max(deg(dst), 1)`` (the in-degree read from
        ``indptr``), so that A is the mean and A^T its exact transpose. Built on the
        graph's device at first use and kept on this instance; ``replace`` and
        ``to`` give new instances, which build their own."""
        from dgll_tpu_torch.ops.chunked import build_chunked_pair

        deg = (self.indptr[1:] - self.indptr[:-1]).clamp_min(1)
        w = torch.reciprocal(deg.float())[self.dst.long()]
        return build_chunked_pair(self.src, self.dst, self.n_node, self.n_node, w)

    @functools.cached_property
    def sum_chunked(self) -> tuple:
        """``mean_chunked``'s layouts weighed by the edge weights (or 1): SAGE's sum."""
        from dgll_tpu_torch.ops.chunked import build_chunked_pair

        return build_chunked_pair(self.src, self.dst, self.n_node, self.n_node,
                                  self.edge_weight)

    def with_windowed(self, min_fill: float = 0.25, min_fraction: float = 0.5,
                      reorder: bool = False) -> "Graph":
        """Attach the windowed SpMM layouts of A and A^T (``ops/windowed.py``), which
        route GCN aggregation through K2 and the residual edges through K1.

        The call declines, returning the caller's graph unchanged, where fewer than
        ``min_fraction`` of the edges of A or of A^T land on the windowed path.
        ``reorder=True`` first relabels the nodes for locality when the cheap capture
        estimate is below ``min_fraction`` (``parallel/reorder.py``); the graph
        returned is then the permuted one, ``node_perm`` mapping back, unless no
        ordering reaches ``min_fraction`` either, when the call declines without
        building the layouts. The decline points are those of the JAX package's
        ``Graph.with_windowed``. The classic layouts are not attached: chain
        ``.with_chunked()`` for them."""
        from dgll_tpu_torch.ops.windowed import build_hybrid

        g = self
        if reorder:
            from dgll_tpu_torch.parallel.reorder import (
                estimate_windowed_fraction,
                reorder_for_locality,
            )

            e = g.n_real_edge
            if estimate_windowed_fraction(_np(g.src)[:e], _np(g.dst)[:e],
                                          min_fill) < min_fraction:
                g, info = reorder_for_locality(g, min_fill=min_fill,
                                               min_fraction=min_fraction)
                if info.get("declined"):
                    return self
        e, n = g.n_real_edge, g.n_real_node
        src, dst = _np(g.src)[:e], _np(g.dst)[:e]
        w = None if g.edge_weight is None else _np(g.edge_weight)[:e]
        # A first: where it declines, A^T's build would be wasted host time
        h = build_hybrid(src, dst, n, n, w, min_fill)
        if h.windowed_fraction < min_fraction:
            return self  # keep the caller's graph, in its own id space
        ht = build_hybrid(dst, src, n, n, w, min_fill)
        if ht.windowed_fraction < min_fraction:
            return self
        dev = g.src.device
        return g.replace(hybrid=h.to(dev), hybrid_t=ht.to(dev))

    # ------------------------------------------------------------- queries
    # (the JAX package's DGraph-parity helpers: host-side conveniences)
    def get_neighbors(self, nodes: Sequence[int]) -> list:
        """The in-neighbours of each node of ``nodes``, a list of id lists."""
        indptr, src = _np(self.indptr), _np(self.src)
        return [list(src[indptr[int(v)]: indptr[int(v) + 1]]) for v in nodes]

    def get_induced_subgraph(self, nodes: Sequence[int]) -> np.ndarray:
        """Dense ``[k, k]`` float32 adjacency of the subgraph induced by ``nodes``:
        ``adj[i, j] = 1`` where ``nodes[j]`` is an in-neighbour of ``nodes[i]``."""
        nodes = np.asarray(list(nodes), dtype=np.int64)
        pos = {int(v): i for i, v in enumerate(nodes)}
        adj = np.zeros((len(nodes), len(nodes)), dtype=np.float32)
        indptr, src = _np(self.indptr), _np(self.src)
        for i, v in enumerate(nodes):
            for u in src[indptr[v]: indptr[v + 1]]:
                j = pos.get(int(u))
                if j is not None:
                    adj[i, j] = 1.0
        return adj

    def _rows(self, t: torch.Tensor, nodes) -> torch.Tensor:
        return t.index_select(0, torch.as_tensor(np.asarray(nodes), dtype=torch.long,
                                                 device=t.device))

    def get_features(self, nodes) -> torch.Tensor:
        """Feature rows of ``nodes``."""
        return self._rows(self.node_feat, nodes)

    def get_labels(self, nodes) -> torch.Tensor:
        """Labels of ``nodes``."""
        return self._rows(self.labels, nodes)

    @property
    def in_degrees(self) -> torch.Tensor:
        """In-degree of every node (padded edges included), ``[n_node]`` int32."""
        return self.indptr[1:] - self.indptr[:-1]

    @property
    def edge_mask(self) -> torch.Tensor:
        """``[n_edge]`` bool: True on real (not padding) edges."""
        return torch.arange(self.n_edge, device=self.src.device) < self.n_real_edge

    @property
    def node_mask(self) -> torch.Tensor:
        """``[n_node]`` bool: True on real (not padding) nodes."""
        return torch.arange(self.n_node, device=self.src.device) < self.n_real_node

    def with_features(self, node_feat=None, labels=None) -> "Graph":
        """The graph with ``node_feat`` and/or ``labels`` replaced (arrays or
        tensors); None keeps the current one."""
        return self.replace(
            node_feat=self.node_feat if node_feat is None else torch.as_tensor(node_feat),
            labels=self.labels if labels is None else torch.as_tensor(labels),
        )

    def _mask_nodes(self, mask: Optional[torch.Tensor]) -> np.ndarray:
        if mask is None:
            return np.zeros((0,), np.int32)
        return np.nonzero(_np(mask))[0].astype(np.int32)

    def get_train_nodes(self) -> np.ndarray:
        """Train split node ids, int32 numpy."""
        return self._mask_nodes(self.train_mask)

    def get_validation_nodes(self) -> np.ndarray:
        return self._mask_nodes(self.val_mask)

    def get_test_nodes(self) -> np.ndarray:
        return self._mask_nodes(self.test_mask)

    def out_degrees_np(self) -> np.ndarray:
        """Out-degree of every node (padded edges included), as int64 numpy."""
        return np.bincount(_np(self.src), minlength=self.n_node).astype(np.int64)

    def to(self, device) -> "Graph":
        """Move every tensor, and the kernel layouts, to ``device``."""
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            moved[f.name] = v.to(device) if hasattr(v, "to") else v
        return Graph(**moved)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_graph(g: Graph, node_multiple: int = 8, edge_multiple: int = 128) -> Graph:
    """Pad node/edge counts up to multiples.

    Padded edges are self-loops on a **padded** node (never a real one), so they
    contribute nothing to any real aggregation, weighted or not. If edges need
    padding but the node count is already aligned, one extra block of padding nodes
    is added so that a padded target exists; padded feature rows are zero.
    """
    pn = _round_up(max(g.n_node, 1), node_multiple)
    pe = _round_up(max(g.n_edge, 1), edge_multiple)
    if pe > g.n_edge and pn == g.n_node:
        pn += node_multiple
    if pn == g.n_node and pe == g.n_edge:
        return g

    dn, de = pn - g.n_node, pe - g.n_edge
    indptr, src, dst = _np(g.indptr), _np(g.src), _np(g.dst)
    if dn:
        indptr = np.concatenate([indptr, np.full((dn,), g.n_edge, np.int32)])
    pad_target = pn - 1
    if de:
        src = np.concatenate([src, np.full((de,), pad_target, np.int32)])
        dst = np.concatenate([dst, np.full((de,), pad_target, np.int32)])
        indptr = indptr.copy()
        indptr[-1] = pe

    def _pad_rows(x, rows):
        if x is None or rows == 0:
            return x
        x = _np(x)
        return _tensor(np.pad(x, [(0, rows)] + [(0, 0)] * (x.ndim - 1)))

    ew = g.edge_weight
    if ew is not None and de:
        ew = _tensor(np.concatenate([_np(ew), np.zeros((de,), np.float32)]))

    return g.replace(
        indptr=_tensor(indptr, torch.int32),
        src=_tensor(src, torch.int32),
        dst=_tensor(dst, torch.int32),
        edge_weight=ew,
        node_feat=_pad_rows(g.node_feat, dn),
        labels=_pad_rows(g.labels, dn),
        train_mask=_pad_rows(g.train_mask, dn),
        val_mask=_pad_rows(g.val_mask, dn),
        test_mask=_pad_rows(g.test_mask, dn),
        n_node=pn,
        n_edge=pe,
    )
