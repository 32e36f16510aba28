"""The windowed SpMM layout for graphs with source locality, and its plain version.

Counterpart of ``dgll_tpu/ops/windowed.py``. Edges are grouped by (destination
128-row block, source 512-row window); each group is cut into sub-chunks of at most
``SUB`` edges whose sources span at most ``SUB`` rows of ``x`` from a 16-aligned
sub-window start; groups that would fill their sub-chunks below ``min_fill`` go to
a RESIDUAL edge list, which the row-gathering kernel K1 sums (``HybridCSR``).

The partition into windowed and residual edges is the JAX builder's, cut for cut:
it decides ``windowed_fraction``, and through it whether ``Graph.with_windowed``
attaches the layout at all. It does not depend on the JAX chunk size ``eb``, which
only packs four (or eight) sub-chunks into one TPU grid step.

The storage is the port's own, laid out for the CUDA kernel K2
(``csrc/spmm_windowed.cu``), which stages each sub-chunk's rows of ``x`` in shared
memory and has one warp own each destination row. No chunks, no odd chunk count,
no 8-row metadata tiles, no per-sub-chunk planes:

* the windowed edges in (row block, sub-chunk, destination, source) order, each with
  its global source ``src``, destination ``rows`` and ``weight``;
* per sub-chunk its edge range ``sub_ptr``, the first staged row of ``x``
  ``sub_x0`` (window start plus the sub-window offset) and the number of rows to
  stage ``sub_nx`` (up to the sub-chunk's largest source, at most ``SUB``);
* per destination 128-row block its sub-chunk range ``blk_ptr``; a block without
  windowed edges has an empty range, and the kernel writes its rows all the same.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from dgll_tpu_torch.ops.chunked import (
    R_BLOCK,
    ChunkedCSR,
    build_chunked,
    edge_sum_reference,
)

WIN_ROWS = 512   # source rows per window: edges group by (row block, window)
SUB = 128        # edges per sub-chunk, and rows of its sub-window


def _sub_window_off(lo: int) -> int:
    """Sub-window start within the window: clamped into [0, WIN_ROWS - SUB] and
    aligned down to 16 rows, as the JAX builder cuts it."""
    return int(min(max(lo, 0), WIN_ROWS - SUB)) & ~15


@dataclass
class WindowedCSR:
    """The windowed edges, sub-chunk by sub-chunk, over ``n_rows`` output rows."""

    src: torch.Tensor      # [nnz] int32, global source row of x
    rows: torch.Tensor     # [nnz] int32, global destination row
    weight: torch.Tensor   # [nnz] float32
    sub_ptr: torch.Tensor  # [n_sub + 1] int32, edge range of each sub-chunk
    sub_x0: torch.Tensor   # [n_sub] int32, first x row the sub-chunk stages
    sub_nx: torch.Tensor   # [n_sub] int32, x rows it stages (<= SUB)
    blk_ptr: torch.Tensor  # [n_rows // R_BLOCK + 1] int32, sub-chunk range per block
    n_rows: int            # padded up to a multiple of R_BLOCK
    n_cols: int

    @property
    def n_sub(self) -> int:
        return self.sub_x0.numel()

    @property
    def n_row_blocks(self) -> int:
        return self.n_rows // R_BLOCK

    def to(self, device) -> "WindowedCSR":
        return WindowedCSR(self.src.to(device), self.rows.to(device),
                           self.weight.to(device), self.sub_ptr.to(device),
                           self.sub_x0.to(device), self.sub_nx.to(device),
                           self.blk_ptr.to(device), self.n_rows, self.n_cols)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def build_windowed(
    src: np.ndarray,
    dst: np.ndarray,
    n_rows: int,
    n_cols: int,
    weight: Optional[np.ndarray] = None,
    min_fill: float = 0.25,
) -> Tuple[WindowedCSR, Optional[np.ndarray]]:
    """Pack a COO edge list into the windowed layout (host, numpy).

    Returns ``(layout, residual_edge_indices)``; the residual indices (into the input
    arrays, in the JAX builder's order) are None when every edge is windowed.
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if len(src) and (src.min() < 0 or src.max() >= n_cols
                     or dst.min() < 0 or dst.max() >= n_rows):
        raise ValueError("edge endpoints out of range for the layout")
    w = np.ones(len(src), np.float32) if weight is None else np.asarray(weight, np.float32)
    nb = -(-n_rows // R_BLOCK)
    n_win = max(1, -(-n_cols // WIN_ROWS))
    if max(nb * R_BLOCK, len(src)) >= 2**31:
        raise ValueError("layout exceeds int32 indexing")

    # sort edges by (dst block, src window, src) and find the groups
    blk = dst // R_BLOCK
    win = src // WIN_ROWS
    order = np.lexsort((src, win, blk))
    so, do, wo, bo, wno = src[order], dst[order], w[order], blk[order], win[order]
    gkey = bo * n_win + wno
    gstart = np.flatnonzero(np.r_[True, gkey[1:] != gkey[:-1]])
    gend = np.r_[gstart[1:], len(so)]

    # groups too small to fill one sub-chunk to min_fill go residual at once
    sizes = gend - gstart
    big = sizes >= max(min_fill * SUB, 1.0)
    pre_resid = order[~np.repeat(big, sizes)]

    subs: list = []    # (first, end, x0) of each kept sub-chunk, in group order
    resid: list = []   # (first, end) of each group sent residual by its fill
    for gs, ge in zip(gstart[big], gend[big]):
        base = int(wno[gs]) * WIN_ROWS
        here = []
        i = gs
        while i < ge:
            x0 = base + _sub_window_off(int(so[i]) - base)
            # the longest run of <= SUB edges whose sources stay below x0 + SUB
            # (the JAX builder shrinks the run one edge at a time to the same end)
            j = i + int(np.searchsorted(so[i:min(i + SUB, ge)], x0 + SUB, side="left"))
            here.append((i, j, x0))
            i = j
        if ge - gs < min_fill * len(here) * SUB:
            resid.append((gs, ge))
        else:
            subs.extend(here)

    if subs:
        s = np.asarray(subs, np.int64)
        lens = s[:, 1] - s[:, 0]
        sub_of_edge = np.repeat(np.arange(len(s)), lens)
        first = np.repeat(s[:, 0] - np.r_[0, np.cumsum(lens)[:-1]], lens)
        idx = first + np.arange(len(sub_of_edge))
        # within a sub-chunk: by destination, then source (one warp per row)
        idx = idx[np.lexsort((so[idx], do[idx], sub_of_edge))]
        sub_ptr = np.r_[0, np.cumsum(lens)]
        sub_x0 = s[:, 2]
        sub_nx = so[s[:, 1] - 1] - sub_x0 + 1
        blk_ptr = np.searchsorted(bo[s[:, 0]], np.arange(nb + 1), side="left")
    else:
        idx = np.zeros(0, np.int64)
        sub_ptr, sub_x0, sub_nx = np.zeros(1), np.zeros(0), np.zeros(0)
        blk_ptr = np.zeros(nb + 1)

    parts = ([pre_resid] if len(pre_resid) else []) + [order[gs:ge] for gs, ge in resid]
    resid_idx = np.concatenate(parts) if parts else None
    layout = WindowedCSR(
        src=_i32(so[idx]), rows=_i32(do[idx]), weight=torch.from_numpy(wo[idx].copy()),
        sub_ptr=_i32(sub_ptr), sub_x0=_i32(sub_x0), sub_nx=_i32(sub_nx),
        blk_ptr=_i32(blk_ptr), n_rows=nb * R_BLOCK, n_cols=int(n_cols),
    )
    return layout, resid_idx


@dataclass
class HybridCSR:
    """The windowed layout plus, where some edges lack locality, a K1 layout of the
    residual edges over the same row space; one SpMM operand.

    ``windowed_fraction`` is the share of edges on the windowed path."""

    win: WindowedCSR
    res: Optional[ChunkedCSR]
    windowed_fraction: float = 1.0

    def to(self, device) -> "HybridCSR":
        res = None if self.res is None else self.res.to(device)
        return HybridCSR(self.win.to(device), res, self.windowed_fraction)


def build_hybrid(
    src: np.ndarray,
    dst: np.ndarray,
    n_rows: int,
    n_cols: int,
    weight: Optional[np.ndarray] = None,
    min_fill: float = 0.25,
) -> HybridCSR:
    win, resid_idx = build_windowed(src, dst, n_rows, n_cols, weight, min_fill)
    if resid_idx is None or not len(resid_idx):
        return HybridCSR(win=win, res=None, windowed_fraction=1.0)
    w = None if weight is None else np.asarray(weight)[resid_idx]
    res = build_chunked(np.asarray(src)[resid_idx], np.asarray(dst)[resid_idx],
                        n_rows, n_cols, w)
    frac = 1.0 - len(resid_idx) / max(len(np.asarray(src)), 1)
    return HybridCSR(win=win, res=res, windowed_fraction=float(frac))


def build_hybrid_pair(src, dst, n_rows, n_cols, weight=None,
                      min_fill=0.25) -> Tuple[HybridCSR, HybridCSR]:
    """Hybrid layouts for A and A^T (the transpose drives the backward pass)."""
    a = build_hybrid(src, dst, n_rows, n_cols, weight, min_fill)
    at = build_hybrid(dst, src, n_cols, n_rows, weight, min_fill)
    return a, at


def spmm_windowed_reference(c: WindowedCSR, x: torch.Tensor,
                            bias: Optional[torch.Tensor] = None,
                            activation: Optional[str] = None,
                            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of K2: ``act(A_win @ x + bias)`` in f32 over the padded
    row space ``[c.n_rows, F]``, stored in ``out_dtype`` (default ``x.dtype``).

    Counterpart of ``spmm_windowed_xla``. Differentiable through autograd."""
    return edge_sum_reference(c.rows, c.src, c.weight, c.n_rows, x, bias, activation,
                              out_dtype)
