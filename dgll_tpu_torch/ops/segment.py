"""Segment reductions over edge lists.

Counterpart of ``dgll_tpu/ops/segment.py`` for what the GAT slice uses:
``segment_sum`` and ``segment_softmax``. ``segment_softmax`` is the per-destination
softmax of ``GATConv``'s COO branch and of the oracle the fused GAT op is held
against. Each op takes a static ``num_segments``; segment ids are int32 or int64.
"""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add(0, segment_ids, data)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Numerically stable softmax within segments (the GAT edge softmax)."""
    index = segment_ids.long().view(-1, *([1] * (logits.dim() - 1))).expand_as(logits)
    seg_max = logits.new_full((num_segments, *logits.shape[1:]), -torch.inf)
    seg_max = seg_max.scatter_reduce(0, index, logits, "amax")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    shifted = logits - seg_max.index_select(0, segment_ids)
    unnorm = torch.where(torch.isfinite(shifted), torch.exp(shifted), 0.0)
    denom = segment_sum(unnorm, segment_ids, num_segments)
    return unnorm / torch.clamp_min(denom, 1e-16).index_select(0, segment_ids)
