"""Sparse(A) x Dense(X) aggregation and per-edge dot products over a COO edge list.

Counterpart of ``dgll_tpu/ops/spmm.py``: ``spmm_coo`` is a gather of source rows, a
per-edge weight and a scatter-add into the destinations, the aggregation for graphs
that carry no kernel layout; ``sddmm_coo`` the per-edge scores. Both are
differentiable through autograd.
"""
from __future__ import annotations

from typing import Optional

import torch

# The COO path materialises an [E, F] message matrix; above this many bytes the
# feature dim is processed in 128-wide tiles so that full-graph aggregation at
# scale stays inside device memory. Small and hot paths are untouched.
_MSG_TILE_BYTES = 2 << 30


def _msg_f_tiles(src: torch.Tensor, f: int, itemsize: int):
    if int(src.shape[0]) * f * itemsize <= _MSG_TILE_BYTES or f <= 128:
        return None
    return list(range(0, f, 128))


def _aggregate(src, dst, x, n_dst, edge_weight):
    msg = x.index_select(0, src)
    if edge_weight is not None:
        msg = msg * edge_weight[:, None].to(msg.dtype)
    out = torch.zeros((n_dst, x.shape[-1]), dtype=msg.dtype, device=x.device)
    return out.index_add(0, dst, msg)


def spmm_coo(
    src: torch.Tensor,
    dst: torch.Tensor,
    x: torch.Tensor,
    n_dst: int,
    edge_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """out[i] = sum_{(u -> i) in E} w_e * x[u]."""
    f = x.shape[-1]
    tiles = _msg_f_tiles(src, f, x.element_size())
    if tiles is not None:
        return torch.cat(
            [_aggregate(src, dst, x[:, lo:lo + 128], n_dst, edge_weight)
             for lo in tiles],
            dim=-1,
        )
    return _aggregate(src, dst, x, n_dst, edge_weight)


def sddmm_coo(src: torch.Tensor, dst: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense matmul: per-edge ``e_k = <a[dst_k], b[src_k]>``, ``[E]``
    (counterpart of ``dgll_tpu/ops/spmm.py:sddmm_coo``; the COO oracle of K9)."""
    return (a.index_select(0, dst) * b.index_select(0, src)).sum(-1)
