"""SpMM kernel wrapper: ``act(A @ x + bias)`` with its backward on A^T.

Counterpart of ``dgll_tpu/ops/pallas/segment_matmul.py:spmm_chunked``. The kernel is
``csrc/segment_matmul.cu`` (weighted CSR, f32 accumulation, fused bias and ReLU; rows
of more than ``SPLIT_EDGES`` edges cut into segments by the layout's ``split``
schedule, whose f32 partials a second pass adds in segment order, into scratch this
wrapper allocates). It has two routes (``k1_route``): float32 input, and bfloat16
input, which takes the other rows in runs of whole rows (the layout's ``items``) and
has compile-time cases for identity columns and unit weights. The backward runs the
same kernel on the transpose layout: ``dx = A^T (act'(out) * g)``, and ``db =
sum(g)`` in plain torch.

A tensor on the CPU goes through the plain version (``ops/chunked.py:
spmm_chunked_reference``); a tensor on a CUDA device launches the kernel or raises.

``spmm_edges`` is the same kernel with runtime or identity columns and unit or
runtime weights, summing per-edge messages (the GAT layer's aggregation and backward
scatter).

``launches_fwd`` and ``launches_bwd`` count the calls of the kernel from the forward
and the backward (one per ``spmm_csr_cuda`` call, whether or not it also ran the
second pass), so that a run can show it went through the kernel; ``launches_bf16``
counts every ``spmm_csr_cuda`` call that launched the bfloat16 route.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from dgll_tpu_torch.ops.chunked import ChunkedCSR, spmm_chunked_reference
from dgll_tpu_torch.ops.cuda.build import load_library

launches_fwd = 0
launches_bwd = 0
launches_bf16 = 0

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


class K1Route(NamedTuple):
    """How a K1 call runs: ``kernel`` "float32" (``dgll_spmm_csr``) or "bfloat16"
    (``dgll_spmm_csr_bf16``); ``vec`` columns a lane and 2^``log_g`` lanes a row's
    columns; on the bfloat16 route, whether the columns are the identity and the
    weights 1, which it takes as compile-time cases that load nothing (the float32
    route loads ``edge_ids`` and ``unit_weight`` instead)."""

    kernel: str
    vec: int
    log_g: int
    identity_cols: bool
    unit_weights: bool


def k1_route(x: torch.Tensor, identity_cols: bool = False,
             unit_weights: bool = False) -> K1Route:
    """K1's route for input ``x`` ([rows, F]): from its dtype, its width and its
    pointer's alignment, and the caller's column and weight kinds, nothing else."""
    f = x.shape[1]
    vec = _vector_width(x, f)
    if x.dtype == torch.float32:
        return K1Route("float32", vec, _lane_groups(f, vec), False, False)
    if x.dtype == torch.bfloat16:
        return K1Route("bfloat16", vec, _lane_groups(f, vec), identity_cols, unit_weights)
    raise ValueError(f"unsupported dtype {x.dtype}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


@functools.cache
def _entry(name: str):
    return getattr(load_library(), f"dgll_{name}")


def _launch(name: str, dev: torch.device, *args) -> None:
    """Call the C entry ``dgll_<name>`` with ``args`` and the current stream of
    ``dev``, on ``dev``; raise if it reports an error. A kernel of a few tens of
    microseconds waits on this host path, so the entry is looked up once, the device
    is switched only when it is not the current one, and the stream is read as a raw
    handle (``current_stream(dev).cuda_stream`` without the ``Stream`` object)."""
    if dev.index == torch.cuda.current_device():
        err = _entry(name)(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = _entry(name)(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + load_library().dgll_cuda_error_string(err).decode())


def _check(name: str, t: torch.Tensor, dtype, device, numel=None) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {device}, "
                         f"got {t.dtype} on {t.device}")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: need {numel} elements, got {t.numel()}")


def spmm_csr_cuda(c: ChunkedCSR, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  activation: Optional[str] = None, out_dtype=None,
                  cols: Optional[torch.Tensor] = None,
                  weights: Optional[torch.Tensor] = None, identity_cols: bool = False,
                  unit_weights: bool = False) -> torch.Tensor:
    """Run the kernel once: ``act(A @ x + bias)`` as ``[c.n_rows, F]``, in one C call
    that launches pass 1 and, where the layout has split rows, pass 2.

    ``cols`` and ``weights`` ([nnz], in the layout's edge order) override the
    layout's ``src`` and ``weight``, as in ``spmm_chunked_reference``; ``cols`` must
    index rows of ``x``. ``identity_cols`` (edge e reads row e of ``x``, which has a
    row an edge) and ``unit_weights`` (every weight 1) stand for ``c.edge_ids`` and
    ``c.unit_weight`` in their place.
    """
    global launches_bf16
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type != "cuda" or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x: need a contiguous 2-D CUDA tensor")
    if x.dtype not in _DTYPE_CODE or out_dtype not in (x.dtype, torch.float32):
        raise ValueError(f"unsupported dtypes: x {x.dtype}, out {out_dtype}")
    if activation not in (None, "relu"):
        raise ValueError(f"unknown activation {activation!r}")
    if (identity_cols and cols is not None) or (unit_weights and weights is not None):
        raise ValueError("identity_cols and unit_weights stand in for cols and weights")
    dev, f, nnz = x.device, x.shape[1], c.src.numel()
    if cols is None and not identity_cols and x.shape[0] < c.n_cols:
        raise ValueError(f"x has {x.shape[0]} rows, the layout reads {c.n_cols}")
    if identity_cols and x.shape[0] < nnz:
        raise ValueError(f"x has {x.shape[0]} rows, identity columns read {nnz}")
    if not 0 < f < 2**21 or c.n_rows <= 0:
        raise ValueError(f"empty or too wide: n_rows {c.n_rows}, F {f}")
    route = k1_route(x, identity_cols, unit_weights)
    if route.kernel == "float32":
        cols = c.edge_ids if identity_cols else cols
        weights = c.unit_weight if unit_weights else weights
    if cols is None and not route.identity_cols:
        cols = c.src
    if weights is None and not route.unit_weights:
        weights = c.weight
    _check("indptr", c.indptr, torch.int32, dev, c.n_rows + 1)
    if cols is not None:
        _check("cols", cols, torch.int32, dev, nnz)
    if weights is not None:
        _check("weights", weights, torch.float32, dev, nnz)
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
        _check("bias", bias, torch.float32, dev, f)

    sc = c.split  # built from c.indptr, on its device
    out = x.new_empty((c.n_rows, f), dtype=out_dtype)
    partial = x.new_empty((sc.n_seg, f), dtype=torch.float32) if sc.n_seg else None
    split_args = (sc.seg_beg.data_ptr(), sc.seg_end.data_ptr(), sc.split_row.data_ptr(),
                  sc.split_ptr.data_ptr(), _ptr(partial), sc.n_seg, sc.n_split)
    relu = int(activation == "relu")
    if route.kernel == "float32":
        name = "spmm_csr"
        args = (c.indptr.data_ptr(), cols.data_ptr(), weights.data_ptr(), x.data_ptr(),
                _ptr(bias), out.data_ptr(), c.n_rows, f, route.vec, route.log_g, relu,
                *split_args, sc.max_edges)
    else:
        it = c.items  # built from c.indptr, on its device
        name = "spmm_csr_bf16"
        args = (c.indptr.data_ptr(), _ptr(cols), _ptr(weights), x.data_ptr(), _ptr(bias),
                out.data_ptr(), f, _DTYPE_CODE[out_dtype], route.vec, route.log_g, relu,
                *split_args, it.item_beg.data_ptr(), it.item_end.data_ptr(), it.n_items,
                it.max_rows)
    _launch(name, dev, *args)
    if route.kernel == "bfloat16":
        launches_bf16 += 1
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
    attention. The kernel takes the defaults as its identity-column and unit-weight
    cases. Not differentiable; the launch counts in ``launches_bwd`` when
    ``backward``, else in ``launches_fwd``."""
    global launches_fwd, launches_bwd
    if not _uses_kernel(msg):
        return spmm_chunked_reference(c, msg,
                                      cols=c.edge_ids if cols is None else cols,
                                      weights=c.unit_weight if weights is None else weights)
    out = spmm_csr_cuda(c, msg, cols=cols, weights=weights, identity_cols=cols is None,
                        unit_weights=weights is None)
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
