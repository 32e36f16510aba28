"""SpMM kernel wrapper: ``act(A @ x + bias)`` with its backward on A^T.

Counterpart of ``dgll_tpu/ops/pallas/segment_matmul.py:spmm_chunked``. The kernel is
``csrc/segment_matmul.cu`` (weighted CSR, f32 accumulation, fused bias and ReLU; rows
of more than ``SPLIT_EDGES`` edges cut into segments by the layout's ``split``
schedule, whose f32 partials a second pass adds in segment order, into scratch this
wrapper allocates). The backward runs the same kernel on the transpose layout:
``dx = A^T (act'(out) * g)``, and ``db = sum(g)`` in plain torch.

A tensor on the CPU goes through the plain version (``ops/chunked.py:
spmm_chunked_reference``); a tensor on a CUDA device launches the kernel or raises.

``spmm_edges`` is the same kernel with runtime columns and unit weights, summing
per-edge messages (the GAT layer's aggregation and backward scatter).

``launches_fwd`` and ``launches_bwd`` count the calls of the kernel from the forward
and the backward (one per ``spmm_csr_cuda`` call, whether or not it also ran the
second pass), so that a run can show it went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from dgll_tpu_torch.ops.chunked import ChunkedCSR, spmm_chunked_reference
from dgll_tpu_torch.ops.cuda.build import load_library

launches_fwd = 0
launches_bwd = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _uses_kernel(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor (run the
    plain version); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"the kernels run on cpu or cuda tensors, not {x.device}")


def _vector_width(x: torch.Tensor, f: int, max_vec: int = 8,
                  full_warp: bool = False) -> int:
    """Columns per lane: the widest load (at most 16 bytes and ``max_vec`` columns)
    that divides F and fits the pointer's alignment; with ``full_warp``, also narrow
    enough that F fills 32 lanes where F allows; else 1."""
    size = x.element_size()
    vec = min(max_vec, 16 // size)
    while vec > 1 and (f % vec or x.data_ptr() % (vec * size)
                       or (full_warp and f // vec < 32)):
        vec //= 2
    return vec


def _lane_groups(f: int, vec: int) -> int:
    """log2 of K1's lanes per edge: the power of two that covers F / vec vector
    columns, at most a warp. A warp then takes 32 >> log2 edges at a time."""
    return min(5, (f // vec - 1).bit_length())


def _check(name: str, t: torch.Tensor, dtype, device, numel=None) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {device}, "
                         f"got {t.dtype} on {t.device}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: need {numel} elements, got {t.numel()}")


def spmm_csr_cuda(c: ChunkedCSR, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  activation: Optional[str] = None, out_dtype=None,
                  cols: Optional[torch.Tensor] = None,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the kernel once: ``act(A @ x + bias)`` as ``[c.n_rows, F]``, in one C call
    that launches pass 1 and, where the layout has split rows, pass 2.

    ``cols`` and ``weights`` ([nnz], in the layout's edge order) override the
    layout's ``src`` and ``weight``, as in ``spmm_chunked_reference``; ``cols`` must
    index rows of ``x``.
    """
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type != "cuda" or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x: need a contiguous 2-D CUDA tensor")
    if x.dtype not in _DTYPE_CODE or out_dtype not in (x.dtype, torch.float32):
        raise ValueError(f"unsupported dtypes: x {x.dtype}, out {out_dtype}")
    if activation not in (None, "relu"):
        raise ValueError(f"unknown activation {activation!r}")
    dev, f = x.device, x.shape[1]
    if cols is None and x.shape[0] < c.n_cols:
        raise ValueError(f"x has {x.shape[0]} rows, the layout reads {c.n_cols}")
    if not 0 < f < 2**21 or c.n_rows <= 0:
        raise ValueError(f"empty or too wide: n_rows {c.n_rows}, F {f}")
    cols = c.src if cols is None else cols
    weights = c.weight if weights is None else weights
    _check("indptr", c.indptr, torch.int32, dev, c.n_rows + 1)
    _check("cols", cols, torch.int32, dev, c.src.numel())
    _check("weights", weights, torch.float32, dev, c.src.numel())
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
        _check("bias", bias, torch.float32, dev, f)

    sc = c.split  # built from c.indptr, on its device
    out = torch.empty((c.n_rows, f), dtype=out_dtype, device=dev)
    partial = torch.empty((sc.n_seg, f), dtype=torch.float32, device=dev)
    vec = _vector_width(x, f)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.dgll_spmm_csr(
            c.indptr.data_ptr(), cols.data_ptr(), weights.data_ptr(),
            x.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            c.n_rows, f, _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], vec,
            _lane_groups(f, vec), int(activation == "relu"),
            sc.seg_beg.data_ptr(), sc.seg_end.data_ptr(), sc.split_row.data_ptr(),
            sc.split_ptr.data_ptr(), partial.data_ptr() if sc.n_seg else None,
            sc.n_seg, sc.n_split, sc.max_edges,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError("spmm_csr kernel launch failed: "
                           + lib.dgll_cuda_error_string(err).decode())
    return out


class _SpmmChunked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, c, ct, activation, msg_dtype):
        global launches_fwd
        xm = x if msg_dtype is None else x.to(msg_dtype)
        if _uses_kernel(x):
            out = spmm_csr_cuda(c, xm, bias, activation, out_dtype=x.dtype)
            launches_fwd += 1
        else:
            out = spmm_chunked_reference(c, xm, bias, activation, out_dtype=x.dtype)
        ctx.ct, ctx.activation, ctx.msg_dtype = ct, activation, msg_dtype
        ctx.n_in, ctx.x_dtype = x.shape[0], x.dtype
        ctx.bias_dtype = None if bias is None else bias.dtype
        if activation == "relu":
            ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        global launches_bwd
        if ctx.activation == "relu":
            (out,) = ctx.saved_tensors
            g = torch.where(out > 0, g, 0.0)
        g = g.contiguous()
        dx = db = None
        if ctx.needs_input_grad[0]:
            gm = g if ctx.msg_dtype is None else g.to(ctx.msg_dtype)
            # A^T's sources are A's destination rows (< c.n_rows), so g, already
            # padded to c.n_rows, feeds the transpose layout directly.
            if _uses_kernel(g):
                dx_full = spmm_csr_cuda(ctx.ct, gm, out_dtype=g.dtype)
                launches_bwd += 1
            else:
                dx_full = spmm_chunked_reference(ctx.ct, gm, out_dtype=g.dtype)
            # rows of x past the transpose layout's row space have no out-edges
            short = ctx.n_in - dx_full.shape[0]
            if short > 0:
                dx_full = torch.nn.functional.pad(dx_full, (0, 0, 0, short))
            dx = dx_full[: ctx.n_in].to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            db = g.sum(0).to(ctx.bias_dtype)
        return dx, db, None, None, None, None


def spmm_edges(c: ChunkedCSR, msg: torch.Tensor, cols: Optional[torch.Tensor] = None,
               backward: bool = False,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of per-edge messages, ``[c.n_rows, F]``: ``out[r]`` is the sum of
    ``weights[e] * msg[cols[e]]`` over the edges e of row r. ``cols`` defaults to the
    identity (``msg`` in the layout's edge order, the GAT forward); the GAT backward
    passes A^T's layout and ``t_slot_perm``. ``weights`` ([nnz] float32, in the
    layout's edge order) default to 1; the round-4 path's ``spmm_dyn`` passes its
    attention. Not differentiable; the launch counts in ``launches_bwd`` when
    ``backward``, else in ``launches_fwd``."""
    global launches_fwd, launches_bwd
    cols = c.edge_ids if cols is None else cols
    weights = c.unit_weight if weights is None else weights
    if not _uses_kernel(msg):
        return spmm_chunked_reference(c, msg, cols=cols, weights=weights)
    out = spmm_csr_cuda(c, msg, cols=cols, weights=weights)
    if backward:
        launches_bwd += 1
    else:
        launches_fwd += 1
    return out


def spmm_chunked(c: ChunkedCSR, ct: ChunkedCSR, x: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, activation: Optional[str] = None,
                 msg_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``act(A @ x + bias)`` over the padded row space ``[c.n_rows, F]``; ``ct`` is
    the transpose layout (A^T), which the backward runs the kernel on.

    Differentiable in ``x`` and ``bias``. ``msg_dtype=torch.bfloat16`` casts ``x``
    before the kernel so the edge-sized gather moves at half width, with f32
    accumulation; the output stays in ``x.dtype``.
    """
    return _SpmmChunked.apply(x, bias, c, ct, activation, msg_dtype)
