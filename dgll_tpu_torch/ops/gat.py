"""Differentiable sparse attention ops and the round-4 GAT attention layers.

Counterpart of ``dgll_tpu/ops/pallas/gat.py``. The ops compose the kernel wrappers
(CUDA kernels on CUDA tensors, plain versions on CPU tensors) into
``torch.autograd.Function``s where the JAX package has a ``custom_vjp``:

* ``spmm_msg``: ``out[r] = sum of msg[e]`` over row r's edges (K1, unit weights);
  backward K7.
* ``spmm_dyn``: ``out[r] = sum of weights[e] * msg[e]`` (K1, runtime weights);
  backward K7 for ``dmsg`` and K9 for ``dweights``.
* ``sddmm``: ``e[k] = <a[row of k], msg[k]>`` (K9); backward K1 with weights ``g``
  for ``da`` and K7 for ``dmsg``.

The layers, at the JAX signatures and return shapes:

* ``gat_attention_chunked``: single head. Forward: K10 (rows to edges, row max and
  sum) and K1 with runtime weights; backward K7, K9, K10 and K1 on A^T.
* ``gat_attention_chunked_multihead``: ``H`` heads batched per launch. Forward: K6′,
  K6 max, K6 sum and K1; backward K6 sum_all, K6′, K7 and K1 on A^T.
* ``gat_attention_chunked_fused``: the fused op of ``ops/cuda/gat_fused.py``.

``h`` holds the projected features of a full graph, ``[n, H*F]`` with ``c.n_cols <=
n <= c.n_rows`` (the JAX layers take ``n = c.n_rows``). Each layer gathers the
source rows once (``msg = h[src]``); the gather's VJP scatters the message gradient
back by source with K1 on A^T through ``t_slot_perm``, as the fused op does, so ``c``
must come from ``build_chunked_pair``. Per-edge arrays are ``[nnz, ...]`` in A's
edge order, where the JAX ops use ``[n_chunk * EB]`` slots; there are no padding
slots to mask.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from dgll_tpu_torch.ops.chunked import ChunkedCSR
from dgll_tpu_torch.ops.cuda.edge_ops import sddmm_edges
from dgll_tpu_torch.ops.cuda.gat_fused import expand_rows, gat_attention_fused
from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_edges
from dgll_tpu_torch.ops.edge_ops import (
    edge_softmax_chunked_fast,
    edge_softmax_chunked_multi,
    rows_to_edges_d,
    rows_to_edges_multi,
)


class _SpmmMsg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msg, c):
        ctx.c = c
        return spmm_edges(c, msg)

    @staticmethod
    def backward(ctx, g):
        return expand_rows(ctx.c, g.contiguous()), None


class _SpmmDyn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msg, weights, c):
        ctx.c = c
        ctx.save_for_backward(msg, weights)
        return spmm_edges(c, msg, weights=weights)

    @staticmethod
    def backward(ctx, g):
        msg, weights = ctx.saved_tensors
        g = g.contiguous()
        dmsg = dw = None
        if ctx.needs_input_grad[0]:
            dmsg = weights[:, None] * expand_rows(ctx.c, g)
        if ctx.needs_input_grad[1]:
            dw = sddmm_edges(ctx.c, g, msg)
        return dmsg, dw, None


class _Sddmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, msg, c):
        ctx.c = c
        ctx.save_for_backward(a, msg)
        return sddmm_edges(c, a, msg)

    @staticmethod
    def backward(ctx, g):
        a, msg = ctx.saved_tensors
        g = g.contiguous()
        da = dmsg = None
        if ctx.needs_input_grad[0]:      # da[r] = the sum of g[k] * msg[k] over row r
            da = spmm_edges(ctx.c, msg, backward=True, weights=g)
        if ctx.needs_input_grad[1]:      # dmsg[k] = g[k] * a[row of k]
            dmsg = g[:, None] * expand_rows(ctx.c, a)
        return da, dmsg, None


class _GatherSrc(torch.autograd.Function):
    """``msg = h[c.src]``; the VJP sums each edge's gradient into its source row with
    K1 on A^T, reading it in A's order through ``t_slot_perm``."""

    @staticmethod
    def forward(ctx, h, c, ct):
        ctx.c, ctx.ct, ctx.n = c, ct, h.shape[0]
        return h.index_select(0, c.src)

    @staticmethod
    def backward(ctx, g):
        dh = spmm_edges(ctx.ct, g.contiguous(), ctx.c.t_slot_perm, backward=True)
        if dh.shape[0] < ctx.n:  # sources past A^T's row space have no out-edges
            dh = F.pad(dh, (0, 0, 0, ctx.n - dh.shape[0]))
        return dh[:ctx.n], None, None


def spmm_msg(c: ChunkedCSR, ct: ChunkedCSR, msg: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum of msg[e]`` over row r's edges, ``[c.n_rows, F]``, for messages
    already weighted per edge; differentiable in ``msg`` (the VJP is one K7)."""
    return _SpmmMsg.apply(msg.contiguous(), c)


def spmm_dyn(c: ChunkedCSR, ct: ChunkedCSR, msg: torch.Tensor,
             weights: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum of weights[e] * msg[e]`` over row r's edges, ``[c.n_rows, F]``;
    differentiable in ``msg`` and ``weights [nnz]`` (attention aggregation)."""
    return _SpmmDyn.apply(msg.contiguous(), weights.contiguous(), c)


def sddmm(c: ChunkedCSR, ct: ChunkedCSR, a: torch.Tensor,
          msg: torch.Tensor) -> torch.Tensor:
    """``e[k] = <a[row of k], msg[k]>`` per edge, ``[nnz]``; differentiable in ``a
    [n_rows, F]`` and ``msg [nnz, F]``."""
    return _Sddmm.apply(a.contiguous(), msg.contiguous(), c)


def _check_layer(c: ChunkedCSR, h: torch.Tensor, width: int) -> None:
    if h.dim() != 2 or h.shape[1] != width or not c.n_cols <= h.shape[0] <= c.n_rows:
        raise ValueError(f"h: need [n, {width}] with {c.n_cols} <= n <= {c.n_rows}, "
                         f"got {tuple(h.shape)}")
    if c.t_slot_perm is None:
        raise ValueError("the layout has no t_slot_perm: build it with build_chunked_pair")


def _leaky(z: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(z > 0, z, slope * z)


def gat_attention_chunked(c: ChunkedCSR, ct: ChunkedCSR, h: torch.Tensor,
                          a_src: torch.Tensor, a_dst: torch.Tensor,
                          negative_slope: float = 0.2) -> torch.Tensor:
    """Single-head sparse GAT aggregation: ``h [n, F]``, ``a_src``/``a_dst [F]``;
    returns ``[c.n_rows, F]``. Differentiable in ``h``, ``a_src`` and ``a_dst``."""
    _check_layer(c, h, a_src.numel())
    msg = _GatherSrc.apply(h.contiguous(), c, ct)         # the one gather, [nnz, F]
    sc_src = msg @ a_src                                  # [nnz]
    s_dst = F.pad(h @ a_dst, (0, c.n_rows - h.shape[0]))  # [n_rows]
    e = _leaky(sc_src + rows_to_edges_d(c, s_dst), negative_slope)
    alpha = edge_softmax_chunked_fast(c, e[:, None])[:, 0]
    return spmm_dyn(c, ct, msg, alpha)


def gat_attention_chunked_multihead(c: ChunkedCSR, ct: ChunkedCSR, h: torch.Tensor,
                                    a_src: torch.Tensor, a_dst: torch.Tensor,
                                    negative_slope: float = 0.2) -> torch.Tensor:
    """Multi-head sparse GAT: ``h [n, H*F]``, ``a_src``/``a_dst [H, F]``; returns
    ``[c.n_rows, H, F]``. One gather, one softmax over all heads, and the attention
    premultiplies the messages, so that the aggregation is one unit-weight K1 at the
    full width ``H*F``. Differentiable in ``h``, ``a_src`` and ``a_dst``."""
    heads, f = a_src.shape
    _check_layer(c, h, heads * f)
    n, nnz = h.shape[0], c.src.numel()
    msg = _GatherSrc.apply(h.contiguous(), c, ct).view(nnz, heads, f)
    sc_src = (msg * a_src).sum(-1)                        # [nnz, H]
    s_dst = F.pad((h.view(n, heads, f) * a_dst).sum(-1), (0, 0, 0, c.n_rows - n))
    e = _leaky(sc_src + rows_to_edges_multi(c, s_dst), negative_slope)
    alpha = edge_softmax_chunked_multi(c, e)              # [nnz, H]
    out = spmm_msg(c, ct, (msg * alpha[:, :, None]).view(nnz, heads * f))
    return out.view(c.n_rows, heads, f)


def gat_attention_chunked_fused(c: ChunkedCSR, ct: ChunkedCSR, h: torch.Tensor,
                                a_src: torch.Tensor, a_dst: torch.Tensor,
                                negative_slope: float = 0.2,
                                drop_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused multi-head layer (``ops/cuda/gat_fused.py:gat_attention_fused``),
    under the JAX package's name; returns ``[c.n_rows, H, F]``."""
    return gat_attention_fused(c, ct, h, a_src, a_dst, negative_slope, drop_mask)
