"""Plain PyTorch versions of the GAT attention kernels (``csrc/gat_csr.cu``).

Each function computes what one kernel computes, on the layout of
``ops/chunked.py`` (a dst-major CSR of real edges; ``c.rows`` holds each edge's
destination row). Per-edge arrays are ``[nnz, H]`` (``[nnz, F]`` for K7 and K9) in
the layout's edge order, or ``[nnz]`` for the single-head kernels; per-row arrays
are ``[c.n_rows, H]`` or ``[c.n_rows]``. All math is float32.

| Kernel | TPU original | Function here |
| --- | --- | --- |
| K3 | ``gat_fused.py:_stats_kernel`` (``gat_stats``) | ``gat_stats_reference`` |
| K4 | ``gat_fused.py:_alpha_kernel`` (``gat_alpha``) | ``gat_alpha_reference`` |
| K5 | ``gat_fused.py:_bwd_sm_kernel`` (``gat_bwd_softmax``) | ``gat_bwd_softmax_reference`` |
| K6 | ``edge_ops.py:_e2r_multi_kernel``, sum and sum_all modes | ``edges_to_rows_sum_reference`` |
| K6 | the same, max mode | ``edges_to_rows_max_reference`` |
| K6′ | ``edge_ops.py:_r2e_multi_kernel`` | ``rows_to_edges_reference`` |
| K7 | ``expand_rows.py:_expand_kernel`` | ``expand_rows_reference`` |
| K9 | ``sddmm.py:_sddmm_kernel`` | ``sddmm_reference`` |
| K10 | ``edge_ops.py:_rows_to_edges_kernel``, ``_reduce_kernel`` | the K6′ and K6 functions on ``[nnz]`` and ``[n_rows]`` |

The TPU layouts carry padding slots (weight 0) that every kernel masks; these
layouts hold none, so nothing is masked. So K6's ``sum_all`` mode, which differs
from ``sum`` only in also summing padding slots (``edge_ops.py:89,307``), is the sum
here. K6′ and K10's rows-to-edges compute what K7 computes, at width H and 1.

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


def leaky_relu(z: torch.Tensor, slope: float) -> torch.Tensor:
    """LeakyReLU with flax's rule at 0 (``z >= 0`` takes the identity): the value is
    the same either way, the gradient there is 1. Under bfloat16 scores tie at 0
    often, and torch's ``leaky_relu`` gives the slope there."""
    return torch.where(z >= 0, z, slope * z)


def gat_stats_reference(c: ChunkedCSR, sc_src: torch.Tensor, s_dst: torch.Tensor,
                        negative_slope: float = 0.2
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: per destination row and head, ``m = max_e e`` and
    ``den = sum_e exp(e - m)`` with ``e = LeakyReLU(sc_src[e] + s_dst[row])``.

    ``sc_src [nnz, H]`` per-edge source scores, ``s_dst [n_rows, H]``. A row without
    edges gives ``m = NEG`` and ``den = 0``.
    """
    h = sc_src.shape[1]
    e = leaky_relu(sc_src + s_dst.index_select(0, c.rows), negative_slope)
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
    e = leaky_relu(z, negative_slope)
    inv = 1.0 / torch.clamp_min(den, 1e-16)
    alpha = (torch.exp(torch.clamp_max(e - m.index_select(0, c.rows), 0.0))
             * inv.index_select(0, c.rows))
    lgrad = torch.where(z > 0, 1.0, negative_slope).to(sc_src.dtype)
    return alpha, lgrad


def edges_to_rows_sum_reference(c: ChunkedCSR, v: torch.Tensor) -> torch.Tensor:
    """K6, sum (and sum_all) mode: ``out[row, h] = sum of v[e, h] over the row's
    edges``, ``[n_rows, H]`` (``[n_rows]`` for ``v [nnz]``)."""
    return v.new_zeros((c.n_rows, *v.shape[1:])).index_add(0, c.rows, v)


def edges_to_rows_max_reference(c: ChunkedCSR, v: torch.Tensor) -> torch.Tensor:
    """K6, max mode: ``out[row, h] = max of v[e, h] over the row's edges``, ``NEG``
    on a row without edges (``edge_ops.py:156``), ``[n_rows, H]`` (``[n_rows]`` for
    ``v [nnz]``)."""
    index = c.rows.long().view(-1, *([1] * (v.dim() - 1))).expand_as(v)
    out = v.new_full((c.n_rows, *v.shape[1:]), NEG)
    return out.scatter_reduce(0, index, v, "amax")


def sddmm_reference(c: ChunkedCSR, a: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """K9: ``out[e] = <a[row of e], msg[e]>``, ``[nnz]``, for ``a [n_rows, F]`` and
    ``msg [nnz, F]``."""
    return (a.index_select(0, c.rows) * msg).sum(-1)


def gat_bwd_softmax_reference(c: ChunkedCSR, alpha: torch.Tensor,
                              dalpha: torch.Tensor, lgrad: torch.Tensor,
                              s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: the softmax VJP ``dz = alpha * (dalpha - S[row]) * lgrad`` per edge
    (``[nnz, H]``) and its per-row sum ``dsd`` (``[n_rows, H]``; 0 on rows without
    edges)."""
    dz = alpha * (dalpha - s.index_select(0, c.rows)) * lgrad
    return dz, edges_to_rows_sum_reference(c, dz)


def expand_rows_reference(c: ChunkedCSR, a: torch.Tensor) -> torch.Tensor:
    """K7: ``out[e] = a[row of e]``, ``[nnz, F]`` (``[nnz]`` for ``a [n_rows]``)."""
    return a.index_select(0, c.rows)


# K6′ and K10's rows-to-edges: K7's function at width H, and on v [n_rows]
rows_to_edges_reference = expand_rows_reference


def gat_attention_coo(src: torch.Tensor, dst: torch.Tensor, h: torch.Tensor,
                      a_src: torch.Tensor, a_dst: torch.Tensor, n_dst: int,
                      negative_slope: float = 0.2,
                      drop_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head sparse GAT attention over the edges ``src -> dst``:
    ``[n_dst, H, F]``. ``h [n, H*F]``, ``a_src``/``a_dst [H, F]``, ``drop_mask
    [E, H]`` in the edges' order multiplies alpha (attention dropout).

    The scores and the softmax are in ``h``'s type; the messages are weighted and
    summed in float32, and the sum is stored in ``h``'s type."""
    heads, f = a_src.shape
    h3 = h.view(h.shape[0], heads, f)
    z = (torch.einsum("nhf,hf->nh", h3, a_dst).index_select(0, dst)
         + torch.einsum("nhf,hf->nh", h3, a_src).index_select(0, src))
    alpha = segment_softmax(leaky_relu(z, negative_slope), dst, n_dst)   # [E, H]
    if drop_mask is not None:
        alpha = alpha * drop_mask.to(alpha.dtype)
    msg = h3.index_select(0, src).float() * alpha.float()[:, :, None]
    out = msg.new_zeros((n_dst, heads, f)).index_add(0, dst, msg)
    return out.to(h.dtype)
