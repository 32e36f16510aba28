"""Sampling base structures: a host-side CSR view and fanout-dense message blocks.

Counterpart of ``dgll_tpu/sampling/base.py`` (``HostGraph``, ``Block``,
``BaseSampler``, ``sample_neighbors_padded``). A ``Block`` keeps the JAX layout:
every destination owns exactly ``fanout`` sampled source slots (drawn with
replacement; slots without a real neighbour are masked and alias the destination),
and ``src_ids = [dst_ids | sampled.flatten()]``, so source slot ``i < n_dst`` is
destination ``i`` itself and aggregation is a reshape and a reduction over the
fanout axis. The block's tensors are views of the sampler's numpy buffers until
``Block.to`` moves them to a device.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch


class HostGraph:
    """Numpy CSR view of a graph for host-side sampling: ``indptr`` over
    destinations, ``src`` the in-neighbours."""

    def __init__(self, indptr: np.ndarray, src: np.ndarray, n_node: int):
        self.indptr = np.asarray(indptr, np.int64)
        self.src = np.asarray(src, np.int64)
        self.n_node = int(n_node)
        self.degrees = np.diff(self.indptr)

    @staticmethod
    def from_graph(g) -> "HostGraph":
        # real nodes and edges only: padded edges sit at the tail by construction
        indptr = g.indptr.cpu().numpy().astype(np.int64)[: g.n_real_node + 1].copy()
        indptr[-1] = min(indptr[-1], g.n_real_edge)
        return HostGraph(indptr, g.src.cpu().numpy()[: g.n_real_edge], g.n_real_node)


def _move(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``. A host tensor bound for a CUDA device is staged in pinned
    memory and copied asynchronously on the current stream, so a producer thread
    does not wait for the steps queued before its copy; the copy is ordered before
    any later work on that stream that reads it."""
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclass
class Block:
    """Fanout-dense bipartite block.

    Layout: ``src_ids = [dst_ids | sampled.flatten()]`` with
    ``n_src = n_dst * (1 + fanout)``; the j-th sampled neighbour of destination ``i``
    lives at source slot ``n_dst + i * fanout + j``. ``neigh_mask[i, j]`` marks slots
    that carry a real neighbour; masked slots alias destination ``i`` with weight 0.
    """

    dst_ids: torch.Tensor      # [n_dst] int32 global ids (padded rows: id lo, mask 0)
    src_ids: torch.Tensor      # [n_dst * (1 + fanout)] int32 global ids
    neigh_mask: torch.Tensor   # [n_dst, fanout] bool
    dst_mask: torch.Tensor     # [n_dst] bool
    fanout: int = 0
    n_dst: int = 0

    @property
    def n_src(self) -> int:
        return self.n_dst * (1 + self.fanout)

    @property
    def n_edge(self) -> int:
        return self.n_dst * self.fanout

    @property
    def src(self) -> torch.Tensor:
        """Local source slot of each edge (the COO view): ``n_dst + e``."""
        return torch.arange(self.n_edge, dtype=torch.int32,
                            device=self.src_ids.device) + self.n_dst

    @property
    def dst(self) -> torch.Tensor:
        """Local destination of each edge: ``e // fanout``."""
        return torch.arange(self.n_dst, dtype=torch.int32,
                            device=self.src_ids.device).repeat_interleave(self.fanout)

    @property
    def edge_weight(self) -> torch.Tensor:
        """Mean-normalised weights: summing with these is the sampled-neighbour mean."""
        return (self.neigh_mask.to(torch.float32) / float(max(self.fanout, 1))).reshape(-1)

    @property
    def num_src_nodes(self) -> int:
        return self.n_src

    @property
    def num_dst_nodes(self) -> int:
        return self.n_dst

    def to(self, device) -> "Block":
        device = torch.device(device)
        return replace(self, dst_ids=_move(self.dst_ids, device),
                       src_ids=_move(self.src_ids, device),
                       neigh_mask=_move(self.neigh_mask, device),
                       dst_mask=_move(self.dst_mask, device))


class BaseSampler:
    """Abstract sampler: ``sample(g, seeds) -> (input_nodes, output_nodes, blocks)``,
    blocks ordered outermost (input side) first."""

    def sample(self, g: HostGraph, seeds: np.ndarray):
        raise NotImplementedError


def sample_neighbors_padded(
    g: HostGraph,
    dst_ids: np.ndarray,
    dst_mask: np.ndarray,
    fanout: int,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample ``fanout`` in-neighbours per node uniformly, with replacement.

    Returns ``(sampled [n, fanout] global ids, mask [n, fanout])``. Zero-degree or
    masked rows fall back to the row's own id with mask 0. The C++ sampler runs where
    the host library is built (``native.sample_neighbors``).
    """
    from dgll_tpu_torch import native

    safe_ids = np.where(dst_mask, dst_ids, 0)
    seed = int(rng.integers(0, 2**63 - 1))
    sampled, mask = native.sample_neighbors(g.indptr, g.src, safe_ids, dst_mask, fanout,
                                            seed)
    sampled = np.where(mask, sampled, dst_ids[:, None])
    return sampled.astype(np.int64), mask
