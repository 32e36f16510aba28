"""SDDMM over the kernel layout, and the segment-op edge softmax.

Counterpart of ``dgll_tpu/ops/pallas/sddmm.py``:

* ``sddmm_chunked`` (``sddmm_chunked_pallas``): K9, per-edge scores
  ``<a[row of e], msg[e]>`` as ``[nnz]`` in the layout's edge order, where ``a`` is
  the destination-side ``[n_rows, F]`` matrix and ``msg [nnz, F]`` the pre-gathered
  source rows. Its kernel is ``csrc/gat_csr.cu``; on CPU tensors the plain version
  ``sddmm_chunked_reference`` (``sddmm_chunked_xla``) runs.
* ``edge_softmax_chunked`` and ``edge_softmax_chunked_heads``: the per-destination
  softmax of per-edge scores (``[nnz]`` and ``[nnz, H]``) with plain segment ops,
  differentiable through autograd: the oracles of the kernel compositions in
  ``ops/edge_ops.py``.
"""
from __future__ import annotations

import torch

from dgll_tpu_torch.ops import gat_csr
from dgll_tpu_torch.ops.chunked import ChunkedCSR
from dgll_tpu_torch.ops.cuda.edge_ops import sddmm_edges as sddmm_chunked
from dgll_tpu_torch.ops.segment import segment_softmax

__all__ = ["edge_softmax_chunked", "edge_softmax_chunked_heads", "sddmm_chunked",
           "sddmm_chunked_reference"]

sddmm_chunked_reference = gat_csr.sddmm_reference


def edge_softmax_chunked_heads(c: ChunkedCSR, scores: torch.Tensor) -> torch.Tensor:
    """Per-destination softmax of ``scores [nnz, H]`` (all heads in one set of
    segment ops), or of ``scores [nnz]``, -> alpha of the same shape."""
    return segment_softmax(scores, c.rows, c.n_rows)


# the JAX package's single-head name (scores [nnz])
edge_softmax_chunked = edge_softmax_chunked_heads
