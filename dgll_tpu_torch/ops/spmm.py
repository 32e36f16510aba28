"""Sparse(A) x Dense(X) aggregation and per-edge dot products over a COO edge list.

Counterpart of ``dgll_tpu/ops/spmm.py``: ``spmm_coo`` is a gather of source rows, a
per-edge weight and a scatter-add into the destinations, the aggregation for graphs
that carry no kernel layout; ``spmm_mean_coo`` and ``spmm_max_coo`` are SAGE's mean
and max over a COO edge list; ``block_aggregate`` is the fanout-dense reduction over
a sampled ``Block``; ``sddmm_coo`` the per-edge scores; ``fused_gcn_layer`` a whole
GCN layer with its own backward. All are differentiable. The JAX package computes
these in XLA, outside any Pallas kernel, so they stay plain PyTorch on every device.
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


def _in_degrees(dst: torch.Tensor, n_dst: int, dtype) -> torch.Tensor:
    ones = torch.ones(dst.shape[0], dtype=dtype, device=dst.device)
    return torch.zeros(n_dst, dtype=dtype, device=dst.device).index_add(0, dst, ones)


def spmm_mean_coo(src, dst, x: torch.Tensor, n_dst: int) -> torch.Tensor:
    """Mean over in-neighbours (SAGE "mean"); rows without in-edges give 0."""
    tot = spmm_coo(src, dst, x, n_dst)
    return tot / torch.clamp_min(_in_degrees(dst, n_dst, x.dtype), 1)[:, None]


def _segment_amax(src, dst, x, n_dst):
    msg = x.index_select(0, src)
    out = torch.zeros((n_dst, x.shape[-1]), dtype=x.dtype, device=x.device)
    return out.scatter_reduce(0, dst.long()[:, None].expand_as(msg), msg, "amax",
                              include_self=False)


def spmm_max_coo(src, dst, x: torch.Tensor, n_dst: int) -> torch.Tensor:
    """Max over in-neighbours (SAGE "max"); rows without in-edges give 0. Where
    several messages tie for a row's max, the gradient is split among them, as in
    the JAX package's ``segment_max``."""
    tiles = _msg_f_tiles(src, x.shape[-1], x.element_size())
    if tiles is not None:
        return torch.cat([_segment_amax(src, dst, x[:, lo:lo + 128], n_dst)
                          for lo in tiles], dim=-1)
    return _segment_amax(src, dst, x, n_dst)


def block_aggregate(x: torch.Tensor, n_dst: int, fanout: int, neigh_mask: torch.Tensor,
                    kind: str = "mean") -> torch.Tensor:
    """Fanout-dense aggregation for sampled ``Block``s: no gather, no scatter.

    A block's source rows are ``[dst | sampled.flatten()]``, so the sampled slab
    ``x[n_dst : n_dst * (1 + fanout)]`` reshapes to ``[n_dst, fanout, F]`` and the
    aggregation is a reduction over the fanout axis, with the conventions of the
    JAX package's ``block_aggregate``:

    * ``mean``: plain mean over all slots (masked slots alias the destination's own
      row by construction, as ``spmm_mean_coo`` over the block's COO view);
    * ``sum``: the mask-weighted sum divided by ``fanout`` (``spmm_coo`` with
      ``Block.edge_weight``), not a raw sum;
    * ``max``: max over all slots (ties split the gradient).
    """
    neigh = x[n_dst: n_dst * (1 + fanout)].reshape(n_dst, fanout, x.shape[-1])
    if kind == "mean":
        return neigh.mean(dim=1)
    if kind == "sum":
        w = neigh_mask.to(neigh.dtype)[..., None]
        return (neigh * w).sum(dim=1) / float(max(fanout, 1))
    if kind == "max":
        return neigh.amax(dim=1)
    raise ValueError(f"unknown aggregation {kind!r}")


def sddmm_coo(src: torch.Tensor, dst: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """Sampled dense-dense matmul: per-edge ``e_k = <a[dst_k], b[src_k]>``, ``[E]``
    (counterpart of ``dgll_tpu/ops/spmm.py:sddmm_coo``; the COO oracle of K9)."""
    return (a.index_select(0, dst) * b.index_select(0, src)).sum(-1)


class _FusedGCN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, dst, edge_weight, x, w, n_dst):
        agg = spmm_coo(src, dst, x @ w, n_dst, edge_weight)
        ctx.save_for_backward(src, dst, edge_weight, x, w, agg > 0)
        return torch.relu(agg)

    @staticmethod
    def backward(ctx, g):
        src, dst, edge_weight, x, w, relu_mask = ctx.saved_tensors
        g = torch.where(relu_mask, g, 0.0)
        gh = spmm_coo(dst, src, g, x.shape[0], edge_weight)  # A^T g: roles swapped
        return None, None, None, gh @ w.T, x.T @ gh, None


def fused_gcn_layer(src: torch.Tensor, dst: torch.Tensor,
                    edge_weight: Optional[torch.Tensor], x: torch.Tensor,
                    w: torch.Tensor, n_dst: int) -> torch.Tensor:
    """``relu(A (X W))`` with a hand-written backward: the semantic twin of the
    reference's fused GCN kernel (``gcn_extension.cpp:22-57`` forward).

    The backward masks the output gradient by ``A (X W) > 0``, then computes
    ``gh = A^T g``, ``grad_X = gh W^T`` and ``grad_W = X^T gh``, as
    ``gcn_fused_kernel.cu:77-188`` does except for the mask: the reference's CUDA
    backward omits the ReLU mask, and both packages apply it. ``src``, ``dst`` and
    ``edge_weight`` get no gradient.
    """
    return _FusedGCN.apply(src, dst, edge_weight, x, w, int(n_dst))
