"""Multi-layer uniform neighbour sampler. Counterpart of
``dgll_tpu/sampling/neighbor.py``.

The returned block list is outermost first: ``fanouts[0]`` is the block nearest the
raw input features. A whole multi-layer batch is one call of the host library
(``native.sample_block_fused``), which writes the frontier-growth buffer in place;
every ``Block`` is a zero-copy view of it. Without the library the per-layer numpy
path samples instead. Both packages build the same C++ and draw the per-batch seed
from the same numpy ``Generator``, so their blocks are equal batch for batch.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dgll_tpu_torch import native
from dgll_tpu_torch.sampling.base import BaseSampler, Block, HostGraph, sample_neighbors_padded


def _blocks_from_fused(ids, mask, sizes, fanouts) -> List[Block]:
    """Wrap the fused buffers into outermost-first Blocks (zero-copy views).

    ``fanouts`` is in model order; the buffer grew innermost first, so layer k of
    the growth (fanout ``reversed(fanouts)[k]``) becomes ``blocks[-1-k]``.
    """
    ids_t = torch.from_numpy(ids)
    mask_t = torch.from_numpy(mask.view(np.bool_))
    blocks: List[Block] = []
    for k, fanout in enumerate(reversed(list(fanouts))):
        n_k = sizes[k]
        blocks.insert(0, Block(
            dst_ids=ids_t[:n_k],
            src_ids=ids_t[: sizes[k + 1]],
            neigh_mask=mask_t[n_k: sizes[k + 1]].view(n_k, fanout),
            dst_mask=mask_t[:n_k],
            fanout=int(fanout),
            n_dst=int(n_k),
        ))
    return blocks


class NeighborSampler(BaseSampler):
    def __init__(self, fanouts: Sequence[int], seed: int = 0):
        self.fanouts = [int(f) for f in fanouts]
        self._rng = np.random.default_rng(seed)
        # several DataLoader producers call sample() at once; a Generator is not
        # thread-safe, so the per-batch seed draw takes this lock
        self._rng_lock = threading.Lock()

    # community id range (CommunityNeighborSampler sets it)
    _lo: int = 0
    _hi: Optional[int] = None

    def _padded_seeds(self, seeds, pad_to):
        seeds = np.asarray(seeds, np.int64)
        b = len(seeds) if pad_to is None else int(pad_to)
        dst_ids = np.full(b, self._lo, np.int64)  # padding keeps ids in the range
        dst_ids[: len(seeds)] = seeds
        dst_mask = np.zeros(b, bool)
        dst_mask[: len(seeds)] = True
        return dst_ids, dst_mask

    def _fused(self, g: HostGraph, dst_ids, dst_mask):
        with self._rng_lock:
            batch_seed = int(self._rng.integers(0, 2**63 - 1))
        fused = native.sample_block_fused(
            g.indptr, g.src, dst_ids, dst_mask, list(reversed(self.fanouts)), batch_seed,
            lo=self._lo, hi=self._hi,
        )
        return fused, batch_seed

    def sample(
        self,
        g: HostGraph,
        seeds: np.ndarray,
        pad_to: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray, List[Block]]:
        """Sample the multi-hop neighbourhood of ``seeds``.

        Returns ``(input_nodes, output_nodes, blocks)``: ``input_nodes`` are the global
        ids whose features feed the first block (``blocks[0].src_ids`` as int64
        numpy), ``output_nodes`` the (padded) seeds. ``pad_to`` pads the seed batch to
        a fixed size (default ``len(seeds)``).
        """
        dst_ids, dst_mask = self._padded_seeds(seeds, pad_to)
        fused, batch_seed = self._fused(g, dst_ids, dst_mask)
        if fused is not None:
            ids, mask, sizes = fused
            blocks = _blocks_from_fused(ids, mask, sizes, self.fanouts)
            return ids.astype(np.int64) if blocks else dst_ids, dst_ids, blocks

        # numpy fallback: per-layer sampling and concatenation, with a fresh
        # Generator per batch so that concurrent producers share no state
        rng = np.random.default_rng(batch_seed)
        blocks: List[Block] = []
        frontier, fmask = dst_ids, dst_mask
        for fanout in reversed(self.fanouts):
            sampled, smask = sample_neighbors_padded(g, frontier, fmask, fanout, rng)
            if self._hi is not None or self._lo:
                hi = np.iinfo(np.int64).max if self._hi is None else self._hi
                in_range = (sampled >= self._lo) & (sampled < hi)
                # out-of-range neighbours alias their destination with mask 0, so
                # every id a batch touches stays inside [lo, hi)
                sampled = np.where(in_range, sampled, frontier[:, None])
                smask &= in_range
            grown = np.concatenate([frontier, sampled.reshape(-1)])
            blocks.insert(0, Block(
                dst_ids=torch.from_numpy(frontier.astype(np.int32)),
                src_ids=torch.from_numpy(grown.astype(np.int32)),
                neigh_mask=torch.from_numpy(smask),
                dst_mask=torch.from_numpy(fmask),
                fanout=fanout,
                n_dst=frontier.shape[0],
            ))
            frontier = grown
            fmask = np.concatenate([fmask, smask.reshape(-1)])
        input_nodes = blocks[0].src_ids.numpy().astype(np.int64) if blocks else dst_ids
        return input_nodes, dst_ids, blocks

    def sample_packed(
        self, g: HostGraph, seeds: np.ndarray, pad_to: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Just the frontier-growth buffers every Block is a view of:
        ``(ids int32 [n_final], mask uint8 [n_final])``."""
        dst_ids, dst_mask = self._padded_seeds(seeds, pad_to)
        fused, _ = self._fused(g, dst_ids, dst_mask)
        if fused is not None:
            ids, mask, _ = fused
            return ids, mask
        # no host library: build the buffers from the per-layer fallback blocks
        _, _, blocks = self.sample(g, seeds, pad_to)
        b = len(dst_ids)
        n_final = blocks[0].n_src if blocks else b
        ids = np.empty(n_final, np.int32)
        mask = np.empty(n_final, np.uint8)
        ids[:b] = dst_ids
        mask[:b] = dst_mask
        for blk in reversed(blocks):
            n_k = blk.n_dst
            ids[n_k: n_k * (1 + blk.fanout)] = blk.src_ids.numpy()[n_k:]
            mask[n_k: n_k * (1 + blk.fanout)] = blk.neigh_mask.numpy().reshape(-1)
        return ids, mask

    @staticmethod
    def packed_sizes(batch: int, fanouts: Sequence[int]) -> List[int]:
        """Frontier lengths after each growth layer: ``sizes[0] == batch``."""
        sizes = [int(batch)]
        for f in reversed([int(x) for x in fanouts]):
            sizes.append(sizes[-1] * (1 + f))
        return sizes


# the reference library's class name
DGLLNeighborSampler = NeighborSampler


class CommunityNeighborSampler(NeighborSampler):
    """Neighbour sampler restricted to a community's contiguous id range ``[lo, hi)``:
    seeds and sampled neighbours stay inside it, so every feature row a batch touches
    lies in one contiguous slice (what COG's relabelling creates). Out-of-range
    neighbours are masked out."""

    def __init__(self, fanouts: Sequence[int], community_range: Tuple[int, int],
                 seed: int = 0):
        super().__init__(fanouts, seed)
        self.lo, self.hi = int(community_range[0]), int(community_range[1])
        self._lo, self._hi = self.lo, self.hi

    def sample(self, g: HostGraph, seeds: np.ndarray, pad_to: Optional[int] = None):
        seeds = np.asarray(seeds, np.int64)
        if not ((seeds >= self.lo) & (seeds < self.hi)).all():
            raise ValueError(f"seeds outside the community [{self.lo}, {self.hi})")
        return super().sample(g, seeds, pad_to)
