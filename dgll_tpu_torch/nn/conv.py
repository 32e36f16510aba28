"""Graph convolution layers.

Counterpart of ``dgll_tpu/nn/conv.py``: ``GCNConv``, ``GATConv``, ``SAGEConv`` and
``GINConv``; ``GCN2Conv`` (GCNII's layer) is the port's own, on full graphs only. A
layer takes a *message structure* ``g``: a full ``Graph``; a sampled fanout-dense
``Block``; or a layer-wise sampler's ``SparseBlock`` (host) or ``WeightedBlock``
(device). A block's first ``n_dst`` source rows are the destinations themselves, where
``self_at_head`` holds.

On a full ``Graph`` each layer class declares in ``LAYOUTS`` the kernel layouts a
caller attaches for it before the graph moves to a card, and ``attached_layouts``
takes their union over a model: ``"windowed"`` (``Graph.with_windowed``, tried first:
GCN and GIN) and ``"chunked"`` (``Graph.with_chunked``: GCN, GIN and GAT). SAGE's mean
and sum and GCNII declare none: they build what they read on the graph's device
(``Graph.chunked_pair``).

The layer-wise blocks are chosen by their type, not as a fallback: the JAX package
runs no Pallas kernel on them either. A ``WeightedBlock`` aggregates by a gather
of its slots and an einsum, a ``SparseBlock`` by ``spmm_coo`` with its edge
weights, and ``GATConv`` reads either through its COO view.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from dgll_tpu_torch.graph import Graph
from dgll_tpu_torch.ops.gat_csr import gat_attention_coo, leaky_relu
from dgll_tpu_torch.ops.spmm import block_aggregate, spmm_coo, spmm_max_coo, spmm_mean_coo
from dgll_tpu_torch.sampling.base import SparseBlock, WeightedBlock
from dgll_tpu_torch.utils import profiling

# Each layer's neighbour aggregation is this span while tracing (``utils.profiling``),
# and its backward the span of the same name with ``_bwd``.
AGGREGATE = "dgll.conv.aggregate"


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


def glorot_uniform_(w: torch.Tensor, generator: Optional[torch.Generator] = None):
    """In-place Glorot (Xavier) uniform init, as flax's ``glorot_uniform`` draws a
    2-D parameter: bound ``sqrt(6 / (rows + columns))``. Drawn on the CPU, as
    ``lecun_normal_``."""
    cpu = torch.empty(w.shape, dtype=torch.float32)
    nn.init.xavier_uniform_(cpu, generator=generator)
    with torch.no_grad():
        w.copy_(cpu)
    return w


def _dense(linear: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """``linear(x)`` computed in ``dtype`` (flax's ``Dense(dtype=...)``: the input,
    the weight and the bias cast to it), or as it is where ``dtype`` is None."""
    if dtype is None:
        return linear(x)
    bias = None if linear.bias is None else linear.bias.to(dtype)
    return nn.functional.linear(x.to(dtype), linear.weight.to(dtype), bias)


def _is_dense_block(g) -> bool:
    """A fanout-dense sampled ``Block``: aggregation is a reshape and a reduction."""
    return getattr(g, "neigh_mask", None) is not None and getattr(g, "fanout", 0) > 0


def _is_layerwise_block(g) -> bool:
    """A layer-wise sampler's block: a ``SparseBlock`` or a ``WeightedBlock``."""
    return isinstance(g, (SparseBlock, WeightedBlock))


def _n_dst(g) -> int:
    return g.n_dst if hasattr(g, "n_dst") else g.n_node


def _require_self_at_head(g, layer: str) -> None:
    """Layers that read ``x[:n_dst]`` as the destinations' own features reject blocks
    that break the protocol (source slot i < n_dst is destination i itself)."""
    if not getattr(g, "self_at_head", True):
        raise ValueError(
            f"{layer} needs self features (source slot i < n_dst must be destination "
            "i itself); this block was sampled with include_seeds=False. Use GCNConv, "
            "or sample with include_seeds=True."
        )


def kernel_layouts(g, n_dst: int, device: torch.device):
    """The graph's attached kernel layouts ``(A, A^T)`` (``Graph.with_chunked``), or None
    where the layer runs its plain COO version instead, which it does only on the
    CPU. On any other device a graph without the layouts raises: a CUDA input
    launches the kernels and never falls back to the plain version."""
    c = g.chunked
    if c is not None and c.n_rows >= n_dst:
        return c, g.chunked_t
    if device.type != "cpu":
        raise ValueError(f"an input on {device} runs the kernels, and the graph has no "
                         "kernel layouts: attach them with Graph.with_chunked()")
    return None


def attached_layouts(model: nn.Module) -> tuple:
    """``(layouts, reports)`` of ``model``'s layers: the union of their ``LAYOUTS``,
    ``"windowed"`` before ``"chunked"`` (the order a caller tries them in), and of
    their ``REPORTS``. No layout where every layer builds what it reads."""
    layers = [m for m in model.modules() if hasattr(m, "LAYOUTS")]
    reads = {name for m in layers for name in m.LAYOUTS}
    reports = {k: v for m in layers for k, v in getattr(m, "REPORTS", {}).items()}
    return tuple(n for n in ("windowed", "chunked") if n in reads), reports


def _weighted_aggregate(g, h: torch.Tensor, n_dst: int) -> torch.Tensor:
    """Weighted-sum aggregation: on a ``WeightedBlock`` a gather of its slots and an
    einsum, on a ``SparseBlock`` ``spmm_coo`` with its edge weights (both on any
    device); else through the windowed kernel K2 and K1 on the residual edges when
    the graph carries the windowed layouts (``Graph.with_windowed``), else through
    K1 when it carries the chunked ones (``Graph.with_chunked``), else on a
    ``Block`` through ``block_aggregate``'s "sum" (the mask-weighted mean, on any
    device), else, on the CPU, through ``spmm_coo``. This is the JAX package's order
    of the branches.

    Unlike the JAX package, every feature width goes through the kernels: the
    ``F % 128`` condition there is the TPU matrix unit's tiling rule, and the GPU
    kernels mask a ragged column tile instead. The math is the same.
    """
    if isinstance(g, WeightedBlock):
        rows = h.index_select(0, g.slot.reshape(-1)).reshape(n_dst, g.k, -1)
        return torch.einsum("nk,nkf->nf", g.weight.to(h.dtype), rows)
    if isinstance(g, SparseBlock):
        return spmm_coo(g.src, g.dst, h, n_dst, g.edge_weight)
    hy = getattr(g, "hybrid", None)
    if hy is not None and hy.win.n_rows >= n_dst:
        from dgll_tpu_torch.ops.cuda.spmm_windowed import spmm_hybrid

        return spmm_hybrid(hy, g.hybrid_t, h)[:n_dst]
    c = getattr(g, "chunked", None)
    if (c is None or c.n_rows < n_dst) and _is_dense_block(g):
        return block_aggregate(h, n_dst, g.fanout, g.neigh_mask, "sum")
    layouts = kernel_layouts(g, n_dst, h.device)
    if layouts is not None:
        from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_chunked

        return spmm_chunked(*layouts, h)[:n_dst]
    return spmm_coo(g.src, g.dst, h, n_dst, g.edge_weight)


class GCNConv(nn.Module):
    """``out = A_hat @ (X W) + b``: transform first, so the SpMM runs at the output
    width.

    ``dtype`` sets the compute type of the transform and the aggregation (as flax's
    ``dtype``); the parameters stay float32.
    """

    LAYOUTS = ("windowed", "chunked")  # read by ``_weighted_aggregate``

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
        h = _dense(self.linear, x, self.dtype)
        out = profiling.spanned(AGGREGATE, _weighted_aggregate, g, h, _n_dst(g))
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


class SAGEConv(nn.Module):
    """GraphSAGE: aggregate the neighbours (``mean``, ``sum`` or ``max``), transform
    the aggregate (``neigh``, no bias) and the destinations' own rows ``x[:n_dst]``
    (``self``, with the bias), and concatenate (``[self | neigh]``) or add them.

    On a ``Block`` the aggregation is ``block_aggregate`` (its ``sum`` is the
    mask-weighted mean). On a full ``Graph`` the mean and the sum run kernel K1
    (``spmm_chunked``, its plain version on the CPU) on layouts built from the
    graph's edges on its device at first use (``Graph.chunked_pair`` of ``"mean"`` or
    ``"edges"``): every edge, the mean's ``1 / deg`` or the graph's edge weights on
    each, the backward on A^T; rows without in-edges give 0. The max, and the
    layer-wise blocks' COO views, stay plain PyTorch on every device
    (``spmm_max_coo``, ``spmm_mean_coo``, ``spmm_coo``), as the JAX package computes
    them in XLA.
    """

    LAYOUTS = ()  # the mean and the sum build their own

    def __init__(self, in_features: int, features: int, aggregator: str = "mean",
                 combine: str = "concat", use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if aggregator not in ("mean", "sum", "max"):
            raise ValueError(f"unknown aggregator {aggregator!r}")
        if combine not in ("concat", "sum"):
            raise ValueError(f"unknown combine {combine!r}")
        self.aggregator, self.combine, self.dtype = aggregator, combine, dtype
        self.neigh = nn.Linear(in_features, features, bias=False, device=device)
        self.self = nn.Linear(in_features, features, bias=use_bias, device=device)
        lecun_normal_(self.neigh.weight, generator)
        lecun_normal_(self.self.weight, generator)
        if use_bias:
            nn.init.zeros_(self.self.bias)

    def _aggregate(self, g, x: torch.Tensor, n_dst: int) -> torch.Tensor:
        if _is_dense_block(g):
            return block_aggregate(x, n_dst, g.fanout, g.neigh_mask, self.aggregator)
        if isinstance(g, Graph) and self.aggregator != "max":
            from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_chunked

            profiling.count("conv.aggregate_k1")
            pair = g.chunked_pair("mean" if self.aggregator == "mean" else "edges")
            return spmm_chunked(*pair, x.contiguous())[:n_dst]
        if self.aggregator == "mean":
            return spmm_mean_coo(g.src, g.dst, x, n_dst)
        if self.aggregator == "sum":
            return spmm_coo(g.src, g.dst, x, n_dst, g.edge_weight)
        return spmm_max_coo(g.src, g.dst, x, n_dst)

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        n_dst = _n_dst(g)
        _require_self_at_head(g, "SAGEConv")
        agg = profiling.spanned(AGGREGATE, self._aggregate, g, x, n_dst)
        h_neigh = _dense(self.neigh, agg, self.dtype)
        h_self = _dense(self.self, x[:n_dst], self.dtype)
        if self.combine == "concat":
            return torch.cat([h_self, h_neigh], dim=-1)
        return h_self + h_neigh


class GATConv(nn.Module):
    """Multi-head graph attention: ``e = LeakyReLU(a_src . h[src] + a_dst . h[dst])``
    per edge and head, softmax over each destination's in-edges, then the
    alpha-weighted sum of ``h[src]``. Heads are concatenated or averaged; there is no
    bias, as in the JAX package.

    On a sampled ``Block`` the attention is fanout-dense (``_dense_block``), on a
    layer-wise block it is the COO composition over the block's COO view, both plain
    PyTorch on every device as XLA in the JAX package. On a graph that carries the
    kernel layouts (``Graph.with_chunked``) the layer is the fused op
    ``gat_attention_fused`` (kernels K3-K7 and K1); otherwise, on the CPU only, it
    runs the plain COO composition with ``segment_softmax``
    (``kernel_layouts``). In training mode with
    ``attn_dropout > 0``, alpha is dropped with a mask drawn from the generator
    passed to ``forward`` and scaled by ``1 / (1 - attn_dropout)``.

    Unlike the JAX package, the per-head width is not zero-padded to a multiple of
    128 lanes (a TPU tiling rule; zero columns change nothing).

    ``dtype`` sets the compute type (as flax's ``dtype``): the projection ``h`` and
    the attention vectors are cast to it, the parameters stay float32. Under
    bfloat16 the fused op keeps its scores and softmax in float32 and its messages
    in bfloat16; the dense-block branch runs in bfloat16, as the JAX package's. The
    COO branch (``gat_attention_coo``) sums its messages in float32 and, unlike the
    JAX package, which returns that float32 sum, casts it back to the compute type.
    """

    LAYOUTS = ("chunked",)  # read by the fused op
    REPORTS = {"gat_kernel": "gat_attention_fused"}  # what the CLI reports of it

    def __init__(self, in_features: int, features: int, num_heads: int = 1,
                 concat_heads: bool = True, negative_slope: float = 0.2,
                 attn_dropout: float = 0.0, dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads, self.features, self.dtype = num_heads, features, dtype
        self.concat_heads = concat_heads
        self.negative_slope = negative_slope
        self.attn_dropout = attn_dropout
        self.linear = nn.Linear(in_features, num_heads * features, bias=False,
                                device=device)
        self.attn_src = nn.Parameter(torch.empty(num_heads, features, device=device))
        self.attn_dst = nn.Parameter(torch.empty(num_heads, features, device=device))
        lecun_normal_(self.linear.weight, generator)
        glorot_uniform_(self.attn_src, generator)
        glorot_uniform_(self.attn_dst, generator)

    def _drop_mask(self, shape, device, generator) -> Optional[torch.Tensor]:
        if not self.training or self.attn_dropout == 0.0:
            return None
        keep = 1.0 - self.attn_dropout
        mask = torch.rand(shape, generator=generator, device=device) < keep
        return mask.float() / keep

    def _dense_block(self, g, h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                     n_dst: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        """Attention on a fanout-dense ``Block``: a softmax over each destination's
        ``fanout`` slots (masked slots at -1e9 and weight 0), with no segment op, in
        ``h``'s type."""
        H, F, fo = self.num_heads, self.features, g.fanout
        h = h.reshape(h.shape[0], H, F)
        # per-node score halves, then the slots' (cheaper than per-edge dots)
        s_src = torch.einsum("nhf,hf->nh", h, a_src)
        s_dst = torch.einsum("nhf,hf->nh", h, a_dst)
        neigh_h = h[n_dst: n_dst * (1 + fo)].reshape(n_dst, fo, H, F)
        s_n = s_src[n_dst: n_dst * (1 + fo)].reshape(n_dst, fo, H)
        e = leaky_relu(s_dst[:n_dst, None, :] + s_n, self.negative_slope)
        m = g.neigh_mask[..., None]
        e = torch.where(m, e, -1e9)
        ex = torch.exp(e - e.amax(dim=1, keepdim=True).detach()) * m
        alpha = ex / ex.sum(dim=1, keepdim=True).clamp_min(1e-9)
        mask = self._drop_mask(alpha.shape, h.device, generator)
        if mask is not None:
            alpha = alpha * mask.to(alpha.dtype)
        return torch.einsum("nfh,nfhd->nhd", alpha, neigh_h)

    def _coo(self, g, h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
             n_dst: int, generator: Optional[torch.Generator]) -> torch.Tensor:
        """Attention over the COO edges ``g.src -> g.dst`` (``gat_attention_coo``)."""
        mask = self._drop_mask((g.src.numel(), self.num_heads), h.device, generator)
        return gat_attention_coo(g.src, g.dst, h, a_src, a_dst, n_dst,
                                 self.negative_slope, mask)

    def forward(self, g, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        H, F = self.num_heads, self.features
        n_dst = _n_dst(g)
        _require_self_at_head(g, "GATConv")
        h = _dense(self.linear, x, self.dtype)              # [n, H*F]
        a_src, a_dst = self.attn_src.to(h.dtype), self.attn_dst.to(h.dtype)
        layouts = (None if _is_dense_block(g) or _is_layerwise_block(g)
                   else kernel_layouts(g, n_dst, x.device))
        if layouts is not None:
            from dgll_tpu_torch.ops.cuda.gat_fused import gat_attention_fused

            c, ct = layouts
            with profiling.span(AGGREGATE, h):  # the fused op spans its own backward
                mask = self._drop_mask((c.src.numel(), H), x.device, generator)
                out = gat_attention_fused(c, ct, h, a_src, a_dst, self.negative_slope,
                                          mask)[:n_dst]
        else:
            attend = self._dense_block if _is_dense_block(g) else self._coo
            out = profiling.spanned(AGGREGATE, attend, g, h, a_src, a_dst, n_dst,
                                    generator)
        if self.concat_heads:
            return out.reshape(n_dst, H * F)
        return out.mean(dim=1)


def uniform_(w: torch.Tensor, bound: float,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """In-place uniform init on ``[-bound, bound]``, drawn on the CPU as
    ``lecun_normal_``."""
    cpu = torch.empty(w.shape, dtype=torch.float32)
    nn.init.uniform_(cpu, -bound, bound, generator=generator)
    with torch.no_grad():
        w.copy_(cpu)
    return w


# GCN2Conv's layer after ``P x`` (the initial residual, the identity mapping, the ReLU
# and the next dropout) is this span while tracing, and its backward the span of the
# same name with ``_bwd``.
IDENTITY_MAP = "dgll.conv.identity_map"


def _gcn_aggregate(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """``P x`` over ``g.chunked_pair("gcn")`` through K1 (its plain version on the
    CPU), over K1's whole padded row space."""
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_chunked

    return spmm_chunked(*g.chunked_pair("gcn"), x.contiguous())


class GCN2Conv(nn.Module):
    """GCNII's layer (Chen et al., "Simple and Deep Graph Convolutional Networks",
    ICML 2020) with the model's ReLU and the next layer's dropout: the initial
    residual ``s = (1 - alpha) P x + alpha x0``, the identity mapping ``z = beta (s W)
    + (1 - beta) s``, with ``P = D^-1/2 (A + I) D^-1/2`` and ``W [features,
    features]`` (no bias; ``s @ W``, the paper's orientation), then ``relu(z)``, and
    where ``u`` (the uniforms of the next dropout mask) is given, ``where(u < keep,
    relu(z) / keep, 0)``.

    ``P x`` runs kernel K1 (``spmm_chunked``, its plain version on the CPU) on the
    layouts ``Graph.chunked_pair("gcn")`` builds on the graph's device at first use, the
    backward on A^T. Everything after it is ``ops/cuda/gcnii_fused.py``'s
    ``gcnii_layer``: one forward and one backward kernel on the card (a width that is
    a multiple of 4; another raises there), their plain versions on the CPU. The paper
    defines the layer on full graphs: a sampled block raises. ``W`` is drawn as the
    authors' code draws it, uniform on ``±1/sqrt(features)``.
    """

    LAYOUTS = ()  # ``P`` is built on the graph's device

    def __init__(self, features: int, alpha: float, beta: float, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.alpha, self.beta = alpha, beta
        self.weight = nn.Parameter(torch.empty(features, features, device=device))
        uniform_(self.weight, 1.0 / math.sqrt(features), generator)

    def _layer(self, agg: torch.Tensor, x0: torch.Tensor, u: Optional[torch.Tensor],
               keep: float) -> torch.Tensor:
        from dgll_tpu_torch.ops.cuda.gcnii_fused import gcnii_layer

        return gcnii_layer(agg, x0, self.weight, u, self.alpha, self.beta, keep)

    def forward(self, g, x: torch.Tensor, x0: torch.Tensor,
                u: Optional[torch.Tensor] = None, keep: float = 1.0) -> torch.Tensor:
        if not isinstance(g, Graph):
            raise ValueError(f"GCN2Conv runs on a full Graph (GCNII is defined on full "
                             f"graphs), not on a {type(g).__name__}")
        profiling.count("conv.aggregate_gcn")
        agg = profiling.spanned(AGGREGATE, _gcn_aggregate, g, x)
        return profiling.spanned(IDENTITY_MAP, self._layer, agg, x0, u, keep)


class GINConv(nn.Module):
    """GIN: ``act(mlp((1 + eps) x[:n_dst] + A x))``, the aggregation at the input
    width through ``_weighted_aggregate`` (K1, or K2 and K1, on a graph with the
    kernel layouts). ``eps`` is a learned scalar with ``learn_eps``, else 0;
    ``activation`` None is the identity."""

    LAYOUTS = GCNConv.LAYOUTS

    def __init__(self, in_features: int, features: int, learn_eps: bool = False,
                 activation: Optional[Callable] = torch.relu,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp = nn.Linear(in_features, features, device=device)
        lecun_normal_(self.mlp.weight, generator)
        nn.init.zeros_(self.mlp.bias)
        self.eps = nn.Parameter(torch.zeros((), device=device)) if learn_eps else None
        self.activation, self.dtype = activation, dtype

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        n_dst = _n_dst(g)
        _require_self_at_head(g, "GINConv")
        agg = profiling.spanned(AGGREGATE, _weighted_aggregate, g, x, n_dst)
        eps = 0.0 if self.eps is None else self.eps
        h = _dense(self.mlp, (1.0 + eps) * x[:n_dst] + agg, self.dtype)
        return h if self.activation is None else self.activation(h)
