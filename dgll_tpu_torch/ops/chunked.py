"""The SpMM kernel's layout, and the plain PyTorch version of the kernel.

Counterpart of ``dgll_tpu/ops/chunked.py``. The JAX package packs the edges into
fixed chunks of ``EB`` slots per 128-row block, with an odd chunk count and
one-hot scatter matrices, because a TPU has no atomics and runs its grid in order.
None of that carries over to the GPU: the kernel (``csrc/segment_matmul.cu``) walks
a plain dst-major CSR and needs no atomics. It takes a row of at most
``SPLIT_EDGES`` edges as one work item; a longer row is cut into segments of at
most that many edges (``split_schedule``, built once per layout as
``ChunkedCSR.split``), whose partial sums a second pass adds in segment order. Its
bfloat16 route takes the other rows in runs of whole rows (``item_schedule``, built
once per layout as ``ChunkedCSR.items``), a warp a run.

The API conventions stay:

* the output row space is padded up to a multiple of ``R_BLOCK`` (``n_rows``);
* the layouts hold the edges they are given (``Graph.with_chunked``: the real ones;
  ``Graph.chunked_pair``: every edge, padded ones included), built on their device;
* padded rows and rows without edges come out as ``act(bias)``;
* ``build_chunked_pair`` gives the layouts of A and of A^T, the second driving the
  backward pass, and attaches to A's layout ``t_slot_perm``: for each edge of A^T,
  the index of the same edge in A's edge order. Per-edge values in A's order,
  gathered through it, come out in A^T's order (the GAT backward's scatter).
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

R_BLOCK = 128  # the output row space is padded to a multiple of this
# K1 cuts a row of more in-edges than this into segments of at most this many
SPLIT_EDGES = 512
# K1's bfloat16 route packs the other rows into runs whose rows begin within one
# window of this many edges, at most ITEM_ROWS rows a run (its shared memory)
ITEM_EDGES = 256
ITEM_ROWS = 256


@dataclass
class SplitSchedule:
    """K1's cut of a layout's long rows into segments (``split_schedule``)."""

    seg_beg: torch.Tensor    # [n_seg] int32, first edge of each segment
    seg_end: torch.Tensor    # [n_seg] int32, one past its last edge
    split_row: torch.Tensor  # [n_split] int32, the rows cut into segments, ascending
    split_ptr: torch.Tensor  # [n_split + 1] int32, each split row's range of segments
    max_edges: int           # rows of at most this many edges are not cut

    @property
    def n_seg(self) -> int:
        return self.seg_beg.numel()

    @property
    def n_split(self) -> int:
        return self.split_row.numel()


def split_schedule(indptr: torch.Tensor, max_edges: int = SPLIT_EDGES) -> SplitSchedule:
    """Cut every row of more than ``max_edges`` edges into segments of ``max_edges``
    consecutive edges (the last one shorter), in edge order, on ``indptr``'s device.
    Rows of at most ``max_edges`` edges are left whole and appear nowhere."""
    indptr = indptr.long()
    dev = indptr.device
    deg = indptr[1:] - indptr[:-1]
    split_row = torch.nonzero(deg > max_edges).flatten()
    counts = (deg[split_row] + max_edges - 1) // max_edges
    split_ptr = torch.zeros(split_row.numel() + 1, dtype=torch.long, device=dev)
    torch.cumsum(counts, 0, out=split_ptr[1:])
    seg_row = torch.repeat_interleave(split_row, counts)
    k = (torch.arange(seg_row.numel(), device=dev)
         - torch.repeat_interleave(split_ptr[:-1], counts))
    seg_beg = indptr[seg_row] + k * max_edges
    seg_end = torch.minimum(seg_beg + max_edges, indptr[seg_row + 1])
    return SplitSchedule(seg_beg.int(), seg_end.int(), split_row.int(), split_ptr.int(),
                         int(max_edges))


@dataclass
class ItemSchedule:
    """K1's bfloat16 route's runs of whole rows (``item_schedule``)."""

    item_beg: torch.Tensor  # [n_items] int32, first row of each run
    item_end: torch.Tensor  # [n_items] int32, one past its last row
    max_rows: int           # a run holds at most this many rows

    @property
    def n_items(self) -> int:
        return self.item_beg.numel()


def item_schedule(indptr: torch.Tensor, max_edges: int = SPLIT_EDGES,
                  window: int = ITEM_EDGES, max_rows: int = ITEM_ROWS) -> ItemSchedule:
    """Cut the rows of at most ``max_edges`` edges into runs of consecutive rows, on
    ``indptr``'s device: a run ends before a row of more than ``max_edges`` edges
    (``split_schedule`` cuts those into segments), before a row whose first edge lies
    in another window of ``window`` edges than the run's first row's, and after
    ``max_rows`` rows (rows ``k * max_rows`` begin runs). A run's edges are then one
    contiguous range of fewer than ``window + max_edges``; rows without edges belong
    to runs like any other. Every row lies in one run or is split."""
    indptr = indptr.long()
    dev = indptr.device
    n = indptr.numel() - 1
    split = indptr[1:] - indptr[:-1] > max_edges
    r = torch.arange(n, device=dev)
    begins = torch.ones(n, dtype=torch.bool, device=dev)
    begins[1:] = ((indptr[1:-1] // window != indptr[:-2] // window)
                  | (r[1:] % max_rows == 0) | split[:-1])
    beg = torch.nonzero(begins & ~split).flatten()
    # a run ends at the next row that begins a run or is split
    stops = torch.cat([torch.nonzero(begins | split).flatten(),
                       torch.tensor([n], device=dev)])
    end = stops[torch.searchsorted(stops, beg, right=True)]
    return ItemSchedule(beg.int(), end.int(), int(max_rows))


@dataclass
class ChunkedCSR:
    """Weighted dst-major CSR over ``n_rows`` output rows and ``n_cols`` sources."""

    indptr: torch.Tensor   # [n_rows + 1] int32
    src: torch.Tensor      # [nnz] int32, source (column) of each edge
    weight: torch.Tensor   # [nnz] float32
    rows: torch.Tensor     # [nnz] int32, destination row of each edge (plain version)
    n_rows: int            # padded up to a multiple of R_BLOCK
    n_cols: int
    # [nnz] int32 (build_chunked_pair, on A's layout): t_slot_perm[j] is the index in
    # this layout's edge order of the edge at the transpose layout's edge j
    t_slot_perm: Optional[torch.Tensor] = None

    @functools.cached_property
    def edge_ids(self) -> torch.Tensor:
        """[nnz] int32 identity columns: edge e reads row e of an edge-ordered array."""
        return torch.arange(self.src.numel(), dtype=torch.int32, device=self.src.device)

    @functools.cached_property
    def unit_weight(self) -> torch.Tensor:
        """[nnz] float32 ones: the weights of a plain sum over each row's edges."""
        return torch.ones_like(self.weight)

    @functools.cached_property
    def split(self) -> SplitSchedule:
        """K1's segment schedule of this layout's rows (``split_schedule``), built on
        the layout's device at first use."""
        return split_schedule(self.indptr)

    @functools.cached_property
    def items(self) -> ItemSchedule:
        """K1's bfloat16 route's runs of the rows that ``split`` leaves whole
        (``item_schedule``), built on the layout's device at first use."""
        return item_schedule(self.indptr, self.split.max_edges)

    def to(self, device) -> "ChunkedCSR":
        perm = None if self.t_slot_perm is None else self.t_slot_perm.to(device)
        out = ChunkedCSR(self.indptr.to(device), self.src.to(device),
                         self.weight.to(device), self.rows.to(device),
                         self.n_rows, self.n_cols, perm)
        # schedules already built move with the layout; the rest are built at first use
        for name in ("split", "items"):
            if name in self.__dict__:
                sched = self.__dict__[name]
                out.__dict__[name] = dataclasses.replace(sched, **{
                    f.name: getattr(sched, f.name).to(device)
                    for f in dataclasses.fields(sched)
                    if isinstance(getattr(sched, f.name), torch.Tensor)})
        return out


def _as_tensor(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(a, device=device).to(dtype)


def _sorted_layout(src, dst, n_rows, n_cols, weight) -> Tuple[ChunkedCSR, torch.Tensor]:
    """``build_chunked``'s layout, and its edge order: the input index of each of
    its edges."""
    device = src.device if isinstance(src, torch.Tensor) else None
    src = _as_tensor(src, torch.int64, device)
    dst = _as_tensor(dst, torch.int64, src.device)
    w = (torch.ones(src.numel(), device=src.device) if weight is None
         else _as_tensor(weight, torch.float32, src.device))
    if src.numel() and (src.min() < 0 or src.max() >= n_cols
                        or dst.min() < 0 or dst.max() >= n_rows):
        raise ValueError("edge endpoints out of range for the layout")
    n_rows_pad = -(-n_rows // R_BLOCK) * R_BLOCK
    if max(n_rows_pad, src.numel()) >= 2**31:
        raise ValueError("layout exceeds int32 indexing")

    m = max(int(n_cols), 1)
    key, order = torch.sort(dst * m + src, stable=True)
    rows = key // m
    indptr = torch.searchsorted(rows, torch.arange(n_rows_pad + 1, device=src.device))
    return ChunkedCSR(
        indptr=indptr.int(),
        src=(key - rows * m).int(),
        weight=w[order],
        rows=rows.int(),
        n_rows=n_rows_pad,
        n_cols=int(n_cols),
    ), order


def build_chunked(
    src,
    dst,
    n_rows: int,
    n_cols: int,
    weight=None,
) -> ChunkedCSR:
    """Pack a COO edge list (any order; tensors or arrays) into the kernel's CSR
    layout, with torch ops on the edges' device (numpy arrays and lists: the host).

    Within a row, edges are sorted by source, so that the kernel's gather reads
    ascending rows of ``x``; duplicate edges keep their input order (one stable
    sort of ``dst * n_cols + src``).
    """
    return _sorted_layout(src, dst, n_rows, n_cols, weight)[0]


def build_chunked_pair(
    src,
    dst,
    n_rows: int,
    n_cols: int,
    weight=None,
) -> Tuple[ChunkedCSR, ChunkedCSR]:
    """Layouts for A and A^T (the transpose drives the backward pass), with
    ``a.t_slot_perm`` attached, on the edges' device.

    A^T's edges are sorted by (A's source, A's destination), so ``t_slot_perm`` is
    the inverse of A's sort order composed with A^T's. Duplicate edges keep their
    input order in both, so they pair in a consistent order, as the JAX package's
    lexsort pairs them; per-edge GAT quantities depend only on the endpoints, so
    duplicates carry the same values.
    """
    a, order = _sorted_layout(src, dst, n_rows, n_cols, weight)
    at, order_t = _sorted_layout(dst, src, n_cols, n_rows, weight)
    slot = torch.empty_like(order)
    slot[order] = torch.arange(order.numel(), device=order.device)
    a.t_slot_perm = slot[order_t].int()
    return a, at


def spmm_chunked_reference(
    c: ChunkedCSR,
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    activation: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
    cols: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``act(A @ x + bias)`` in f32, stored in
    ``out_dtype`` (default ``x.dtype``) over the padded row space ``[c.n_rows, F]``.

    ``cols`` ([nnz] int32) and ``weights`` ([nnz] float32), in the layout's edge
    order, override the layout's ``src`` and ``weight``: with ``cols`` the rows of
    ``x`` summed into row r are ``x[cols[e]]`` for the edges e of row r (for
    example per-edge messages, ``x`` of ``nnz`` rows and identity ``cols``).

    Counterpart of ``spmm_chunked_xla``. Differentiable through autograd.
    """
    cols = c.src if cols is None else cols
    weights = c.weight if weights is None else weights
    return edge_sum_reference(c.rows, cols, weights, c.n_rows, x, bias, activation,
                              out_dtype)


def edge_sum_reference(rows: torch.Tensor, cols: torch.Tensor, weights: torch.Tensor,
                       n_rows: int, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                       activation: Optional[str] = None,
                       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``act(sum_e weights[e] * x[cols[e]] into row rows[e] + bias)`` over ``n_rows``
    rows, summed in f32 and stored in ``out_dtype`` (default ``x.dtype``): the plain
    version of every SpMM kernel of the package."""
    msg = x.index_select(0, cols).float() * weights[:, None]
    out = torch.zeros((n_rows, x.shape[-1]), dtype=torch.float32, device=x.device)
    out = out.index_add(0, rows, msg)
    if bias is not None:
        out = out + bias.float()
    if activation == "relu":
        out = torch.relu(out)
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return out.to(x.dtype if out_dtype is None else out_dtype)
