"""Segment reductions over edge lists.

Counterpart of ``dgll_tpu/ops/segment.py``: ``segment_sum``, ``segment_mean``,
``segment_max``, ``segment_min`` and ``segment_softmax``. ``segment_softmax`` is the
per-destination softmax of ``GATConv``'s COO branch and of the oracle the fused GAT
op is held against; ``segment_max`` is the plain oracle of the row maximum K6 takes
in its max mode. Each op takes a static ``num_segments``; segment ids are int32 or
int64. An empty segment gives 0 in every op, as in the JAX package.
"""
from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.index_add(0, segment_ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    tot = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(torch.ones_like(segment_ids, dtype=data.dtype), segment_ids,
                      num_segments)
    return tot / torch.clamp_min(cnt, 1.0).view(-1, *([1] * (data.dim() - 1)))


def _segment_extreme(data, segment_ids, num_segments, reduce):
    index = segment_ids.long().view(-1, *([1] * (data.dim() - 1))).expand_as(data)
    # include_self=False: a segment reduces its own elements only, and an empty one
    # keeps the 0 it starts from
    out = data.new_zeros((num_segments, *data.shape[1:]))
    return out.scatter_reduce(0, index, data, reduce, include_self=False)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max per segment; an empty segment gives 0 (scatter-max-with-zeros)."""
    return _segment_extreme(data, segment_ids, num_segments, "amax")


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Min per segment; an empty segment gives 0."""
    return _segment_extreme(data, segment_ids, num_segments, "amin")


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
