"""Graph convolution layers.

Counterpart of ``dgll_tpu/nn/conv.py``; this slice holds ``GCNConv`` on a full
``Graph``, which carries the kernel layouts ``chunked``/``chunked_t`` when
``Graph.with_chunked`` attached them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from dgll_tpu_torch.ops.spmm import spmm_coo


def lecun_normal_(w: torch.Tensor, generator: Optional[torch.Generator] = None):
    """In-place LeCun normal init of a ``[out, in]`` weight, as flax's ``Dense``
    kernel init draws it: a normal truncated at two standard deviations, with std
    ``sqrt(1/fan_in)/0.87962566`` so that the truncated draw has variance 1/fan_in.

    Drawn on the CPU, so one seed gives the same weights on every device.
    """
    fan_in = w.shape[1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    cpu = torch.empty(w.shape, dtype=torch.float32)
    nn.init.trunc_normal_(cpu, std=std, a=-2 * std, b=2 * std, generator=generator)
    with torch.no_grad():
        w.copy_(cpu)
    return w


def _weighted_aggregate(g, h: torch.Tensor, n_dst: int) -> torch.Tensor:
    """Weighted-sum aggregation: through the SpMM kernel when the graph carries its
    layout (``Graph.with_chunked``), else through ``spmm_coo``.

    Unlike the JAX package, every feature width goes through the kernel: the
    ``F % 128`` condition there is the TPU matrix unit's tiling rule, and the GPU
    kernel masks a ragged column tile instead. The math is the same.
    """
    c = g.chunked
    if c is not None and c.n_rows >= n_dst:
        from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_chunked

        return spmm_chunked(c, g.chunked_t, h)[:n_dst]
    return spmm_coo(g.src, g.dst, h, n_dst, g.edge_weight)


class GCNConv(nn.Module):
    """``out = A_hat @ (X W) + b``: transform first, so the SpMM runs at the output
    width.

    ``dtype`` sets the compute type of the transform and the aggregation (as flax's
    ``dtype``); the parameters stay float32.
    """

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = nn.Linear(in_features, features, bias=False, device=device)
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if use_bias else None)
        self.dtype = dtype
        lecun_normal_(self.linear.weight, generator)

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            h = self.linear(x)
        else:
            h = nn.functional.linear(x.to(self.dtype), self.linear.weight.to(self.dtype))
        out = _weighted_aggregate(g, h, g.n_node)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out
