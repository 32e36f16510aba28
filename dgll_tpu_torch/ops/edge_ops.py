"""Edge<->row primitives of the round-4 GAT attention path, differentiable.

Counterpart of ``dgll_tpu/ops/pallas/edge_ops.py``. Each op moves values between
the rows of the layout (``[n_rows]`` or ``[n_rows, H]``) and its edges (``[nnz]`` or
``[nnz, H]``, in the layout's edge order where the JAX package uses
``[n_chunk_meta * EB]`` slots) through the wrappers of ``ops/cuda/edge_ops.py`` and
``ops/cuda/gat_fused.py``: kernels on CUDA tensors, plain versions on CPU tensors.

* ``rows_to_edges`` (K10, not differentiable) and ``rows_to_edges_d``:
  ``[n_rows] -> [nnz]``, ``out[e] = v[row of e]``; ``rows_to_edges_multi`` (K6′) the
  same for ``[n_rows, H]``. Their VJP is the row sum of the cotangent, K10's and K6's
  ``sum_all``.
* ``edges_to_rows_sum``: per-row sums of ``[nnz]`` (K10) or ``[nnz, H]`` (K6); its
  VJP broadcasts the cotangent back to the edges.
* ``edges_to_rows_max``: per-row maxima, ``NEG`` on rows without edges (K10 or K6
  max). Not differentiable: the max is the softmax's stability shift, whose
  gradient cancels exactly; the JAX op defines it as zero (``edge_ops.py:146-149``),
  and here nothing flows through it.
* ``edge_softmax_chunked_fast`` (per head, the single-head kernels) and
  ``edge_softmax_chunked_multi`` (all heads per launch: four launches forward): the
  per-destination softmax of ``[nnz, H]`` scores.

The JAX ops mask padding slots with ``weight != 0``; this layout holds real edges
only, so nothing is masked (see ``tests/test_torch_edge_ops.py`` for what that
assumes of the edge weights).
"""
from __future__ import annotations

import torch

from dgll_tpu_torch.ops.chunked import ChunkedCSR
from dgll_tpu_torch.ops.cuda import edge_ops as k
from dgll_tpu_torch.ops.cuda import gat_fused as gf
from dgll_tpu_torch.ops.gat_csr import NEG

__all__ = [
    "NEG",
    "edge_softmax_chunked_fast",
    "edge_softmax_chunked_multi",
    "edges_to_rows_max",
    "edges_to_rows_sum",
    "rows_to_edges",
    "rows_to_edges_d",
    "rows_to_edges_multi",
]

rows_to_edges = k.rows_to_edges


def _r2e(c: ChunkedCSR, v: torch.Tensor) -> torch.Tensor:
    v = v.contiguous()
    return k.rows_to_edges(c, v) if v.dim() == 1 else k.rows_to_edges_multi(c, v)


def _e2r_sum(c: ChunkedCSR, e: torch.Tensor) -> torch.Tensor:
    # sum and sum_all are one function on this layout, which has no padding slots
    e = e.contiguous()
    return k.edges_to_rows(c, e, "sum") if e.dim() == 1 else gf.edges_to_rows_sum(c, e)


class _RowsToEdges(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, c):
        ctx.c = c
        return _r2e(c, v)

    @staticmethod
    def backward(ctx, g):
        # the adjoint: dv[r] = the sum of g over row r's edges (sum_all)
        return _e2r_sum(ctx.c, g), None


class _EdgesToRowsSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, e, c):
        ctx.c = c
        return _e2r_sum(c, e)

    @staticmethod
    def backward(ctx, g):
        return _r2e(ctx.c, g), None


def rows_to_edges_d(c: ChunkedCSR, v: torch.Tensor) -> torch.Tensor:
    """Differentiable :func:`rows_to_edges`: ``[n_rows] -> [nnz]``."""
    if v.dim() != 1:
        raise ValueError(f"v: need [n_rows], got {tuple(v.shape)}")
    return _RowsToEdges.apply(v, c)


def rows_to_edges_multi(c: ChunkedCSR, v: torch.Tensor) -> torch.Tensor:
    """``[n_rows, H] -> [nnz, H]`` for all heads in one launch (K6′), differentiable."""
    if v.dim() != 2:
        raise ValueError(f"v: need [n_rows, H], got {tuple(v.shape)}")
    return _RowsToEdges.apply(v, c)


def edges_to_rows_sum(c: ChunkedCSR, e: torch.Tensor) -> torch.Tensor:
    """``out[r] = the sum of e over row r's edges``: ``[nnz] -> [n_rows]`` (K10) or
    ``[nnz, H] -> [n_rows, H]`` (K6, the JAX package's ``_e2r_sum_multi_d``);
    differentiable."""
    return _EdgesToRowsSum.apply(e, c)


def edges_to_rows_max(c: ChunkedCSR, e: torch.Tensor) -> torch.Tensor:
    """``out[r] = the max of e over row r's edges``, ``NEG`` where it has none:
    ``[nnz] -> [n_rows]`` (K10) or ``[nnz, H] -> [n_rows, H]`` (K6, the JAX package's
    ``_e2r_max_multi_d``). No gradient flows through it (see the module note)."""
    e = e.detach().contiguous()
    return k.edges_to_rows(c, e, "max") if e.dim() == 1 else k.edges_to_rows_max(c, e)


def _softmax(c: ChunkedCSR, scores: torch.Tensor, r2e) -> torch.Tensor:
    """The per-destination softmax of ``scores`` (``[nnz]`` or ``[nnz, H]``) from the
    four primitives; ``r2e`` is the differentiable rows-to-edges of that rank."""
    mx = edges_to_rows_max(c, scores)
    mx = torch.where(mx <= NEG / 2, 0.0, mx)
    ex = torch.exp(scores - r2e(c, mx))
    den = edges_to_rows_sum(c, ex)
    return ex / torch.clamp_min(r2e(c, den), 1e-16)


def edge_softmax_chunked_fast(c: ChunkedCSR, scores: torch.Tensor) -> torch.Tensor:
    """Per-destination softmax of ``scores [nnz, H]``, one head at a time through the
    single-head kernels (K10: a max, two broadcasts and a sum per head)."""
    return torch.stack([_softmax(c, scores[:, h], rows_to_edges_d)
                        for h in range(scores.shape[1])], dim=-1)


def edge_softmax_chunked_multi(c: ChunkedCSR, scores: torch.Tensor) -> torch.Tensor:
    """Per-destination softmax of ``scores [nnz, H]``, all heads per launch: K6 max,
    K6′, K6 sum, K6′."""
    return _softmax(c, scores, rows_to_edges_multi)
