"""Plain PyTorch versions of the GAT attention kernels (``csrc/gat_csr.cu``).

Each function computes what one kernel computes, on the layout of
``ops/chunked.py`` (a dst-major CSR of real edges; ``c.rows`` holds each edge's
destination row). Per-edge arrays are ``[nnz, H]`` (``[nnz, F]`` for K7) in the
layout's edge order; per-row arrays are ``[c.n_rows, H]``. All math is float32.

| Kernel | TPU original | Function here |
| --- | --- | --- |
| K3 | ``gat_fused.py:_stats_kernel`` (``gat_stats``) | ``gat_stats_reference`` |
| K4 | ``gat_fused.py:_alpha_kernel`` (``gat_alpha``) | ``gat_alpha_reference`` |
| K5 | ``gat_fused.py:_bwd_sm_kernel`` (``gat_bwd_softmax``) | ``gat_bwd_softmax_reference`` |
| K6 | ``edge_ops.py:_e2r_multi_kernel``, sum mode | ``edges_to_rows_sum_reference`` |
| K7 | ``expand_rows.py:_expand_kernel`` | ``expand_rows_reference`` |

The TPU layouts carry padding slots (weight 0) that every kernel masks; these
layouts hold none, so nothing is masked.

``gat_attention_coo`` is the plain composition of the whole attention layer over a
COO edge list, differentiable through autograd: ``GATConv``'s branch for graphs
without the kernel layouts, and the oracle of the fused op.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from dgll_tpu_torch.ops.chunked import ChunkedCSR
from dgll_tpu_torch.ops.segment import segment_softmax

NEG = -3.0e38  # the row max of a row without edges, as in the JAX package


def _leaky(z: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(z > 0, z, slope * z)


def gat_stats_reference(c: ChunkedCSR, sc_src: torch.Tensor, s_dst: torch.Tensor,
                        negative_slope: float = 0.2
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: per destination row and head, ``m = max_e e`` and
    ``den = sum_e exp(e - m)`` with ``e = LeakyReLU(sc_src[e] + s_dst[row])``.

    ``sc_src [nnz, H]`` per-edge source scores, ``s_dst [n_rows, H]``. A row without
    edges gives ``m = NEG`` and ``den = 0``.
    """
    h = sc_src.shape[1]
    e = _leaky(sc_src + s_dst.index_select(0, c.rows), negative_slope)
    m = sc_src.new_full((c.n_rows, h), NEG)
    m = m.scatter_reduce(0, c.rows.long()[:, None].expand(-1, h), e, "amax")
    ex = torch.exp(e - m.index_select(0, c.rows))
    den = sc_src.new_zeros((c.n_rows, h)).index_add(0, c.rows, ex)
    return m, den


def gat_alpha_reference(c: ChunkedCSR, sc_src: torch.Tensor, s_dst: torch.Tensor,
                        m: torch.Tensor, den: torch.Tensor,
                        negative_slope: float = 0.2
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: per edge and head, ``alpha = exp(min(e - m[row], 0)) / max(den[row],
    1e-16)`` and the LeakyReLU slope factor ``lgrad`` (1 where the score is
    positive, else ``negative_slope``). Both ``[nnz, H]``."""
    z = sc_src + s_dst.index_select(0, c.rows)
    e = _leaky(z, negative_slope)
    inv = 1.0 / torch.clamp_min(den, 1e-16)
    alpha = (torch.exp(torch.clamp_max(e - m.index_select(0, c.rows), 0.0))
             * inv.index_select(0, c.rows))
    lgrad = torch.where(z > 0, 1.0, negative_slope).to(sc_src.dtype)
    return alpha, lgrad


def edges_to_rows_sum_reference(c: ChunkedCSR, v: torch.Tensor) -> torch.Tensor:
    """K6, sum mode: ``out[row, h] = sum of v[e, h] over the row's edges``,
    ``[n_rows, H]``."""
    return v.new_zeros((c.n_rows, v.shape[1])).index_add(0, c.rows, v)


def gat_bwd_softmax_reference(c: ChunkedCSR, alpha: torch.Tensor,
                              dalpha: torch.Tensor, lgrad: torch.Tensor,
                              s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: the softmax VJP ``dz = alpha * (dalpha - S[row]) * lgrad`` per edge
    (``[nnz, H]``) and its per-row sum ``dsd`` (``[n_rows, H]``; 0 on rows without
    edges)."""
    dz = alpha * (dalpha - s.index_select(0, c.rows)) * lgrad
    return dz, edges_to_rows_sum_reference(c, dz)


def expand_rows_reference(c: ChunkedCSR, a: torch.Tensor) -> torch.Tensor:
    """K7: ``out[e] = a[row of e]``, ``[nnz, F]``."""
    return a.index_select(0, c.rows)


def gat_attention_coo(src: torch.Tensor, dst: torch.Tensor, h: torch.Tensor,
                      a_src: torch.Tensor, a_dst: torch.Tensor, n_dst: int,
                      negative_slope: float = 0.2,
                      drop_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head sparse GAT attention over the edges ``src -> dst``:
    ``[n_dst, H, F]``. ``h [n, H*F]``, ``a_src``/``a_dst [H, F]``, ``drop_mask
    [E, H]`` in the edges' order multiplies alpha (attention dropout)."""
    heads, f = a_src.shape
    h3 = h.view(h.shape[0], heads, f)
    z = ((h3 * a_dst).sum(-1).index_select(0, dst)
         + (h3 * a_src).sum(-1).index_select(0, src))
    alpha = segment_softmax(_leaky(z, negative_slope), dst, n_dst)   # [E, H]
    if drop_mask is not None:
        alpha = alpha * drop_mask
    msg = h3.index_select(0, src) * alpha[:, :, None]
    return msg.new_zeros((n_dst, heads, f)).index_add(0, dst, msg)
