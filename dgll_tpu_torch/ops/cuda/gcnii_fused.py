"""GCNII's layer between two K1 sums as one forward and one backward kernel
(``csrc/gcnii_fused.cu``).

``gcnii_layer(agg, h0, w, u, alpha, beta, keep)`` takes K1's sum ``agg = P x`` over its
padded row space ``[n_rows, F]`` (rows from ``n = h0.shape[0]`` on ignored) and
returns the next layer's input ``[n, F]``:

    s   = lerp(agg[:n], h0, alpha)
    z   = beta (s W) + (1 - beta) s
    out = where(u < keep, relu(z) / keep, 0)      (relu(z) where ``u`` is None)

``u`` are the uniforms of the next dropout mask (one ``torch.rand`` of ``[n, F]``, drawn
by the caller in the model's order), kept where below ``keep`` and scaled as
``models._dropout`` does; a ``keep`` of 0 or less drops everything, as ``_dropout``
does at rate 1, and reads no ``u``. Its backward gives ``agg`` a gradient over the
whole padded row space, the padded rows zero, so that K1's backward on A^T reads it as
it is. A NaN in ``z`` stays NaN and passes its gradient on, as ``torch.relu`` does.

On a CUDA tensor the forward is one launch of the forward kernel (counted in
``launches_fwd``), the backward one C call of the backward kernels and the sum of their
per-block ``dW`` partials (counted in ``launches_bwd``); the products are float32 FMA, no
TF32. The kernels take any width that is a multiple of 4 (16, 32 and 64 have their own
kernels with W whole in shared memory; the others walk W in chunks); another width on
the card raises. On a CPU tensor ``gcnii_layer_reference`` and
``gcnii_layer_backward_reference`` run, at any width: the same formulas written out in
PyTorch, the forward the very operations of the composition it replaces (``lerp``,
``addmm``, ``relu`` and ``_dropout``'s select), the backward autograd's formulas for
them. On the card the dropout scale is a multiplication by ``1 / keep`` in float32, as
PyTorch's CUDA division by a Python scalar computes it.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from dgll_tpu_torch.ops.cuda.build import load_library
from dgll_tpu_torch.ops.cuda.segment_matmul import _launch, _uses_kernel

launches_fwd = 0
launches_bwd = 0


def gcnii_layer_reference(agg: torch.Tensor, h0: torch.Tensor, w: torch.Tensor,
                          u: Optional[torch.Tensor], alpha: float, beta: float,
                          keep: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(out, s, flags)``: the forward's output, ``s`` and ``~(z <= 0) & kept`` (bool:
    where relu's backward passes the gradient on, NaN included)."""
    s = torch.lerp(agg[: h0.shape[0]], h0, alpha)
    z = torch.addmm(s, s, w, beta=1.0 - beta, alpha=beta)
    h, passes = torch.relu(z), ~(z <= 0)
    if u is None:
        return h, s, passes
    kept = u < keep
    return torch.where(kept, h / keep, 0.0), s, passes & kept


def gcnii_layer_backward_reference(g: torch.Tensor, flags: torch.Tensor, s: torch.Tensor,
                                   w: torch.Tensor, n_rows: int, alpha: float, beta: float,
                                   keep: Optional[float]
                                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(g_agg [n_rows, F], g_h0, dW)`` from the gradient ``g`` of the output; ``keep``
    None where the forward drew no mask."""
    g_z = torch.where(flags, g if keep is None else g / keep, 0.0)
    g_s = g_z * (1.0 - beta) + g_z.mm(w.t()) * beta
    g_agg = g_s.new_zeros(n_rows, g_s.shape[1])
    g_agg[: g_s.shape[0]] = g_s * (1.0 - alpha)
    return g_agg, g_s * alpha, s.t().mm(g_z) * beta


def _ready(name: str, t: torch.Tensor, dev: torch.device, shape: tuple, dtype) -> torch.Tensor:
    """``t`` checked, as a contiguous 16-byte-aligned tensor the kernels can read."""
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: need {dtype} {shape} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _f32(x: float) -> float:
    """``x`` rounded to float32, as PyTorch's CUDA kernels take a Python scalar."""
    return float(np.float32(x))


def _scale(keep: float) -> float:
    """The dropout's scale of kept values, ``1 / keep`` in float32 (unread where nothing
    is kept)."""
    return _f32(1.0 / _f32(keep)) if keep > 0.0 else 0.0


def gcnii_fused_fwd_cuda(agg: torch.Tensor, h0: torch.Tensor, w: torch.Tensor,
                         u: Optional[torch.Tensor], alpha: float, beta: float,
                         keep: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel: ``(out, s, flags)`` as the reference's."""
    (n, f), dev = h0.shape, h0.device
    if f % 4:
        raise ValueError(f"the GCNII kernels take a width that is a multiple of 4, not {f}")
    if agg.dim() != 2 or agg.shape[0] < n or agg.shape[1] != f:
        raise ValueError(f"agg: need at least {n} rows of {f}, got {tuple(agg.shape)}")
    agg = _ready("agg", agg, dev, tuple(agg.shape), torch.float32)
    h0 = _ready("h0", h0, dev, (n, f), torch.float32)
    w = _ready("w", w, dev, (f, f), torch.float32)
    if u is not None:
        u = _ready("u", u, dev, (n, f), torch.float32)
    # apart: ``s`` is kept for the backward, ``out`` only until the next K1 sum
    out, s = torch.empty(n, f, device=dev), torch.empty(n, f, device=dev)
    flags = torch.empty(n, f, dtype=torch.bool, device=dev)
    _launch("gcnii_fused_fwd", dev, agg.data_ptr(), h0.data_ptr(), w.data_ptr(),
            None if u is None else u.data_ptr(), out.data_ptr(), s.data_ptr(),
            flags.data_ptr(), n, f, _f32(alpha), _f32(beta), _f32(1.0 - beta), _f32(keep),
            _scale(keep))
    return out, s, flags


@functools.cache
def _bwd_blocks(f: int, device_index: int) -> int:
    """The partials of ``dW`` the backward writes at most on that card."""
    with torch.cuda.device(device_index):
        blocks = load_library().dgll_gcnii_fused_bwd_blocks(f)
    if blocks <= 0:
        raise RuntimeError("gcnii_fused_bwd occupancy query failed: "
                           + load_library().dgll_cuda_error_string(-blocks).decode())
    return blocks


def gcnii_fused_bwd_cuda(g: torch.Tensor, flags: torch.Tensor, s: torch.Tensor,
                         w: torch.Tensor, n_rows: int, alpha: float, beta: float,
                         keep: Optional[float]
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One C call of the backward: ``(g_agg, g_h0, dW)`` as the reference's."""
    (n, f), dev = s.shape, s.device
    if f % 4:
        raise ValueError(f"the GCNII kernels take a width that is a multiple of 4, not {f}")
    g = _ready("g", g, dev, (n, f), torch.float32)
    flags = _ready("flags", flags, dev, (n, f), torch.bool)
    w = _ready("w", w, dev, (f, f), torch.float32)
    blocks = _bwd_blocks(f, dev.index if dev.index is not None
                         else torch.cuda.current_device())
    # apart, as each lives as long as its consumer: K1's backward, the sum into h0's
    # gradient, W's gradient
    g_agg, g_h0 = torch.empty(n_rows, f, device=dev), torch.empty(n, f, device=dev)
    dw, partial = torch.empty(f, f, device=dev), torch.empty(blocks, f, f, device=dev)
    scale = 1.0 if keep is None else _scale(keep)
    _launch("gcnii_fused_bwd", dev, g.data_ptr(), flags.data_ptr(), s.data_ptr(),
            w.data_ptr(), g_agg.data_ptr(), g_h0.data_ptr(), partial.data_ptr(),
            dw.data_ptr(), n, n_rows, f, blocks, _f32(alpha), _f32(1.0 - alpha), _f32(beta),
            _f32(1.0 - beta), scale)
    return g_agg, g_h0, dw


class _GcniiLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, agg, h0, w, u, alpha, beta, keep):
        global launches_fwd
        if keep <= 0.0:  # everything dropped: no value is below 0
            u = torch.zeros_like(h0)
        if _uses_kernel(h0):
            out, s, flags = gcnii_fused_fwd_cuda(agg, h0, w, u, alpha, beta, keep)
            launches_fwd += 1
        else:
            out, s, flags = gcnii_layer_reference(agg, h0, w, u, alpha, beta, keep)
        ctx.save_for_backward(flags, s, w)
        ctx.n_rows, ctx.alpha, ctx.beta = agg.shape[0], alpha, beta
        ctx.keep = None if u is None else keep
        return out

    @staticmethod
    def backward(ctx, g):
        global launches_bwd
        flags, s, w = ctx.saved_tensors
        args = (g, flags, s, w, ctx.n_rows, ctx.alpha, ctx.beta, ctx.keep)
        if _uses_kernel(g):
            g_agg, g_h0, dw = gcnii_fused_bwd_cuda(*args)
            launches_bwd += 1
        else:
            g_agg, g_h0, dw = gcnii_layer_backward_reference(*args)
        need = ctx.needs_input_grad
        return (g_agg if need[0] else None, g_h0 if need[1] else None,
                dw if need[2] else None, None, None, None, None)


def gcnii_layer(agg: torch.Tensor, h0: torch.Tensor, w: torch.Tensor,
                u: Optional[torch.Tensor], alpha: float, beta: float,
                keep: float = 1.0) -> torch.Tensor:
    """The next layer's input (see the module's docstring); differentiable in ``agg``,
    ``h0`` and ``w``."""
    return _GcniiLayer.apply(agg, h0, w, u, alpha, beta, keep)
