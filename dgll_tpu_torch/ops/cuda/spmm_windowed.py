"""Windowed SpMM kernel K2, and the hybrid op that composes it with K1.

``spmm_windowed_cuda`` launches K2 (``csrc/spmm_windowed.cu``) over a windowed
layout: ``act(A_win @ x + bias)``. ``spmm_hybrid`` is the counterpart of
``dgll_tpu/ops/pallas/spmm_windowed.py:spmm_hybrid``: ``act(A @ x + bias)`` over a
``HybridCSR``, K2 on the windowed edges plus K1 (``spmm_csr_cuda``) on the residual
edges, both summed in f32, then the bias, ReLU and a cast to ``x.dtype``; where there
is no residual, K2 fuses the bias and ReLU itself. The backward is the same
composition on the transpose layouts with the forward's ReLU mask, and ``db = sum(g)``.

A tensor on the CPU goes through the plain versions (``spmm_windowed_reference``,
``spmm_chunked_reference``); a tensor on a CUDA device launches the kernels or raises.

``launches_fwd`` and ``launches_bwd`` count K2's launches from the forward and the
backward; K1's launches on the residual count in ``segment_matmul``'s counters.
"""
from __future__ import annotations

from typing import Optional

import torch

from dgll_tpu_torch.ops.chunked import spmm_chunked_reference
from dgll_tpu_torch.ops.cuda import segment_matmul as sm
from dgll_tpu_torch.ops.cuda.build import load_library
from dgll_tpu_torch.ops.windowed import HybridCSR, WindowedCSR, spmm_windowed_reference

launches_fwd = 0
launches_bwd = 0


# Columns a lane sums, at most: its f32 sums of 8 destination rows stay in registers
# (32 at most), and a stage of 128 rows of x, 32 lanes wide, at 64 KB in f32.
MAX_VEC = 4


def spmm_windowed_cuda(c: WindowedCSR, x: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       activation: Optional[str] = None, out_dtype=None) -> torch.Tensor:
    """Launch K2 once: ``act(A_win @ x + bias)`` as ``[c.n_rows, F]``."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type != "cuda" or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x: need a contiguous 2-D CUDA tensor")
    if x.dtype not in sm._DTYPE_CODE or out_dtype not in (x.dtype, torch.float32):
        raise ValueError(f"unsupported dtypes: x {x.dtype}, out {out_dtype}")
    if activation not in (None, "relu"):
        raise ValueError(f"unknown activation {activation!r}")
    dev, f = x.device, x.shape[1]
    if x.shape[0] < c.n_cols:
        raise ValueError(f"x has {x.shape[0]} rows, the layout reads {c.n_cols}")
    if not 0 < f < 2**21 or c.n_rows <= 0:
        raise ValueError(f"empty or too wide: n_rows {c.n_rows}, F {f}")
    nnz = c.src.numel()
    sm._check("blk_ptr", c.blk_ptr, torch.int32, dev, c.n_row_blocks + 1)
    sm._check("sub_ptr", c.sub_ptr, torch.int32, dev, c.n_sub + 1)
    sm._check("sub_x0", c.sub_x0, torch.int32, dev, c.n_sub)
    sm._check("sub_nx", c.sub_nx, torch.int32, dev, c.n_sub)
    sm._check("src", c.src, torch.int32, dev, nnz)
    sm._check("rows", c.rows, torch.int32, dev, nnz)
    sm._check("weight", c.weight, torch.float32, dev, nnz)
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
        sm._check("bias", bias, torch.float32, dev, f)

    out = torch.empty((c.n_rows, f), dtype=out_dtype, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.dgll_spmm_windowed(
            c.blk_ptr.data_ptr(), c.sub_ptr.data_ptr(), c.sub_x0.data_ptr(),
            c.sub_nx.data_ptr(), c.src.data_ptr(), c.rows.data_ptr(),
            c.weight.data_ptr(), x.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            c.n_row_blocks, f, sm._DTYPE_CODE[x.dtype], sm._DTYPE_CODE[out_dtype],
            sm._vector_width(x, f, MAX_VEC, full_warp=True), int(activation == "relu"),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError("spmm_windowed kernel launch failed: "
                           + lib.dgll_cuda_error_string(err).decode())
    return out


def _windowed(c: WindowedCSR, x, bias, activation, out_dtype, backward: bool):
    global launches_fwd, launches_bwd
    if not sm._uses_kernel(x):
        return spmm_windowed_reference(c, x, bias, activation, out_dtype)
    out = spmm_windowed_cuda(c, x, bias, activation, out_dtype)
    if backward:
        launches_bwd += 1
    else:
        launches_fwd += 1
    return out


def _residual(c, x, backward: bool):
    if not sm._uses_kernel(x):
        return spmm_chunked_reference(c, x, out_dtype=torch.float32)
    out = sm.spmm_csr_cuda(c, x, out_dtype=torch.float32)
    if backward:
        sm.launches_bwd += 1
    else:
        sm.launches_fwd += 1
    return out


def hybrid_forward(h: HybridCSR, x: torch.Tensor, bias: Optional[torch.Tensor],
                   activation: Optional[str], out_dtype: torch.dtype,
                   backward: bool = False) -> torch.Tensor:
    """``act(A @ x + bias)`` over ``h`` as ``[h.win.n_rows, F]`` in ``out_dtype``,
    not differentiable; ``backward`` says which counters the launches go to. A cut
    that captured no edge launches no K2."""
    if h.res is None:
        return _windowed(h.win, x, bias, activation, out_dtype, backward)
    out = _residual(h.res, x, backward)
    if h.win.src.numel():
        out = _windowed(h.win, x, None, None, torch.float32, backward) + out
    if bias is not None:
        out = out + bias.float()
    if activation == "relu":
        out = torch.relu(out)
    elif activation is not None:
        raise ValueError(f"unknown activation {activation!r}")
    return out.to(out_dtype)


class _SpmmHybrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, h, ht, activation, msg_dtype):
        xm = x if msg_dtype is None else x.to(msg_dtype)
        out = hybrid_forward(h, xm, bias, activation, x.dtype)
        ctx.ht, ctx.activation, ctx.msg_dtype = ht, activation, msg_dtype
        ctx.n_in, ctx.x_dtype = x.shape[0], x.dtype
        ctx.bias_dtype = None if bias is None else bias.dtype
        if activation == "relu":
            ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.activation == "relu":
            (out,) = ctx.saved_tensors
            g = torch.where(out > 0, g, 0.0)
        g = g.contiguous()
        dx = db = None
        if ctx.needs_input_grad[0]:
            gm = g if ctx.msg_dtype is None else g.to(ctx.msg_dtype)
            # A^T reads A's output rows (< h.win.n_rows), which g already covers
            dx_full = hybrid_forward(ctx.ht, gm, None, None, g.dtype, backward=True)
            short = ctx.n_in - dx_full.shape[0]
            if short > 0:
                dx_full = torch.nn.functional.pad(dx_full, (0, 0, 0, short))
            dx = dx_full[: ctx.n_in].to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            db = g.sum(0).to(ctx.bias_dtype)
        return dx, db, None, None, None, None


def spmm_hybrid(h: HybridCSR, ht: HybridCSR, x: torch.Tensor,
                bias: Optional[torch.Tensor] = None, activation: Optional[str] = None,
                msg_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``act(A @ x + bias)`` over the hybrid layouts, ``[h.win.n_rows, F]``; ``ht``
    is the transpose pair, which the backward runs on.

    Differentiable in ``x`` and ``bias``. ``msg_dtype=torch.bfloat16`` casts ``x``
    before the kernels, which then stage and gather rows at half width with f32
    sums; the output stays in ``x.dtype``.
    """
    return _SpmmHybrid.apply(x, bias, h, ht, activation, msg_dtype)
