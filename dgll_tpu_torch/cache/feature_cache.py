"""Device-resident hot-node feature cache. Counterpart of
``dgll_tpu/cache/feature_cache.py``.

For graphs whose feature matrix exceeds device memory, the hottest rows (top degree)
stay resident on the device and misses are served from the host store with one
batched host-to-device copy per minibatch:

* :meth:`HBMFeatureCache.auto_cache` picks the top-scoring rows that fit a byte
  budget (``capacity_for_budget``), :meth:`fill` caches an explicit row set;
* :meth:`fetch` gathers the hits on the device and the misses on the host,
  deduplicated, and scatters them over the hits on the device; the hit/miss split
  is computed on the host from a numpy mirror of the cache map, so fetching never
  waits for the device;
* :meth:`miss_rate` and :meth:`reset_counters` read and clear the counters.

``quantize=True`` stores the cached rows int8 with per-column scales
(``ops/quantize.py:quantize_int8``, kernel K8 on a CUDA device), four times the rows
per byte; ``fetch`` then returns the dequantised hits with the float32 misses
scattered over them. The cache lives on ``device``, a CUDA device unless the caller
asks for the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _host_ids(node_ids) -> np.ndarray:
    if isinstance(node_ids, torch.Tensor):
        node_ids = node_ids.cpu().numpy()
    return np.asarray(node_ids, np.int64)


class HBMFeatureCache:
    def __init__(self, host_features: np.ndarray, device="cuda", quantize: bool = False):
        self.host = np.ascontiguousarray(host_features)
        self.n, self.d = self.host.shape
        self.device = torch.device(device)
        self.quantize = quantize
        self.cache = None     # [k, d] device tensor, or QuantizedFeatures
        self.cache_pos = np.full(self.n, -1, np.int64)  # host mirror: node -> cache row
        self.k = 0
        self.lookups = 0
        self.misses = 0

    # ------------------------------------------------------------------ fill
    def capacity_for_budget(self, budget_bytes: int) -> int:
        """Rows that fit in ``budget_bytes``: one byte a feature when quantised."""
        row = self.d * (1 if self.quantize else self.host.dtype.itemsize)
        return max(0, int(budget_bytes // row))

    def auto_cache(self, scores: np.ndarray, budget_bytes: int) -> int:
        """Cache the top-scoring nodes (typically degrees) within the byte budget."""
        k = min(self.capacity_for_budget(budget_bytes), self.n)
        if k <= 0:
            return 0
        top = np.argpartition(-np.asarray(scores), k - 1)[:k]
        self.fill(top)
        return k

    def device_budget_bytes(self, reserve_bytes: int = 1 << 30) -> Optional[int]:
        """Free device memory for the cache: the card's total memory, less the peak
        PyTorch has allocated and ``reserve_bytes``. None on the CPU, which has no
        such count (probe after the first training step, so that its working memory
        is already in the peak)."""
        if self.device.type != "cuda":
            return None
        total = torch.cuda.get_device_properties(self.device).total_memory
        in_use = torch.cuda.max_memory_allocated(self.device)
        return max(0, int(total) - int(in_use) - int(reserve_bytes))

    def auto_cache_from_device(self, scores: np.ndarray,
                               reserve_bytes: int = 1 << 30) -> int:
        """``auto_cache`` with the budget probed from the device's memory counts."""
        budget = self.device_budget_bytes(reserve_bytes)
        if budget is None:
            return 0
        return self.auto_cache(scores, budget)

    def fill(self, node_ids: np.ndarray) -> None:
        node_ids = _host_ids(node_ids)
        self.k = len(node_ids)
        self.cache_pos[:] = -1
        self.cache_pos[node_ids] = np.arange(self.k)
        rows = torch.from_numpy(self.host[node_ids]).to(self.device)
        if self.quantize:
            from dgll_tpu_torch.ops.quantize import quantize_int8

            self.cache = quantize_int8(rows)
        else:
            self.cache = rows

    @property
    def cached_whole_graph(self) -> bool:
        return self.k >= self.n

    # ----------------------------------------------------------------- fetch
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            # pinned staging: the copy is queued on the current stream without
            # waiting for the work ahead of it
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def fetch(self, node_ids) -> torch.Tensor:
        """Features of ``node_ids`` ``[B]`` (host ids, numpy or a tensor) as
        ``[B, d]`` on the device.

        Hits gather from the cache; each missed row is gathered once on the host and
        shipped in one copy, then expanded to its duplicates and scattered over the
        hits on the device.
        """
        node_ids = _host_ids(node_ids)
        self.lookups += len(node_ids)
        if self.cache is None:
            self.misses += len(node_ids)  # no cache: every row comes from the host
            return self._to_device(np.ascontiguousarray(self.host[node_ids]))

        pos = self.cache_pos[node_ids]
        hit = pos >= 0
        n_miss = int((~hit).sum())
        self.misses += n_miss

        pos_dev = self._to_device(np.where(hit, pos, 0).astype(np.int32))
        if self.quantize:
            out = self.cache.gather(pos_dev)
        else:
            out = self.cache.index_select(0, pos_dev)
        if n_miss:
            miss_idx = np.nonzero(~hit)[0]
            # sampled frontiers repeat hot nodes: ship each missed row once
            uniq, inv = np.unique(node_ids[miss_idx], return_inverse=True)
            miss_feats = self._to_device(self.host[uniq]).to(out.dtype)
            out[self._to_device(miss_idx.astype(np.int64))] = miss_feats.index_select(
                0, self._to_device(inv.reshape(-1).astype(np.int32)))
        return out

    # --------------------------------------------------------------- metrics
    def miss_rate(self) -> Tuple[float, int, int]:
        """``(miss_rate, lookups, misses)``."""
        rate = self.misses / self.lookups if self.lookups else 0.0
        return rate, self.lookups, self.misses

    def reset_counters(self) -> None:
        self.lookups = 0
        self.misses = 0
