"""End-to-end models. Counterpart of ``dgll_tpu/nn/models.py``: ``GCN``, ``GAT``,
``GraphSAGE``, ``GINNode`` and ``GIN``; ``GCNII`` is the port's own (full batch only).

A node classifier's ``forward`` takes one message graph for every layer (full batch)
or a list of sampled blocks, one per layer, outermost first (minibatch), as the
samplers emit them. ``GIN`` classifies whole graphs: one batched graph
(``nn.pooling.batch_graphs``) and its ``graph_id``."""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from dgll_tpu_torch.graph import Graph
from dgll_tpu_torch.nn.conv import (
    GATConv,
    GCN2Conv,
    GCNConv,
    GINConv,
    SAGEConv,
    _dense,
    lecun_normal_,
    uniform_,
)
from dgll_tpu_torch.nn.pooling import Pooling


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]):
    """Inverted dropout with the mask drawn from ``generator`` (flax's rule: keep
    with probability ``1 - rate`` and scale kept values by ``1 / (1 - rate)``)."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    if keep <= 0.0:
        return torch.zeros_like(x)
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def _layer_inputs(g, n_layers: int) -> List:
    """A per-layer sequence from one graph or a list of blocks."""
    if isinstance(g, (list, tuple)):
        if len(g) != n_layers:
            raise ValueError(f"need {n_layers} blocks, got {len(g)}")
        return list(g)
    return [g] * n_layers


class GCN(nn.Module):
    """``n_layers`` GCNConvs with ReLU and dropout between them and ``log_softmax``
    at the end. Dropout applies in training mode, with masks from the generator
    passed to ``forward``."""

    def __init__(self, in_features: int, hidden: int, n_class: int, n_layers: int = 2,
                 dropout: float = 0.5, dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_features] + [hidden] * (n_layers - 1) + [n_class]
        self.convs = nn.ModuleList(
            GCNConv(dims[i], dims[i + 1], dtype=dtype, device=device,
                    generator=generator)
            for i in range(n_layers)
        )
        self.dropout = dropout

    def forward(self, g, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        gs = _layer_inputs(g, len(self.convs))
        for conv, gi in zip(self.convs[:-1], gs):
            x = torch.relu(conv(gi, x))
            if self.training:
                x = _dropout(x, self.dropout, generator)
        x = self.convs[-1](gs[-1], x)
        return torch.log_softmax(x, dim=-1)


class GAT(nn.Module):
    """``n_layers`` GATConvs: the hidden layers concatenate ``num_heads`` heads of
    ``hidden`` features and apply ELU, the output layer averages one head of
    ``n_class``, and ``log_softmax`` ends it (the reference's GAT, ``gatconv.py:
    154-199``). In training mode, dropout ``dropout`` applies to the features before
    each layer and to the attention of the hidden layers, with masks from the
    generator passed to ``forward``. ``dtype`` is every layer's compute type."""

    def __init__(self, in_features: int, hidden: int, n_class: int, num_heads: int = 8,
                 n_layers: int = 2, dropout: float = 0.6, negative_slope: float = 0.2,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        convs = []
        for _ in range(n_layers - 1):
            convs.append(GATConv(in_features, hidden, num_heads, concat_heads=True,
                                 negative_slope=negative_slope, attn_dropout=dropout,
                                 dtype=dtype, device=device, generator=generator))
            in_features = hidden * num_heads
        convs.append(GATConv(in_features, n_class, 1, concat_heads=False,
                             negative_slope=negative_slope, dtype=dtype, device=device,
                             generator=generator))
        self.convs = nn.ModuleList(convs)
        self.dropout = dropout

    def forward(self, g, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        gs = _layer_inputs(g, len(self.convs))
        for conv, gi in zip(self.convs[:-1], gs):
            if self.training:
                x = _dropout(x, self.dropout, generator)
            x = nn.functional.elu(conv(gi, x, generator))
        if self.training:
            x = _dropout(x, self.dropout, generator)
        x = self.convs[-1](gs[-1], x, generator)
        return torch.log_softmax(x, dim=-1)


class GraphSAGE(nn.Module):
    """``n_layers`` SAGEConvs with ReLU and dropout between them; with ``combine``
    "concat" each layer doubles its width, and a last ``out_proj`` Dense maps the
    output layer's ``2 * n_class`` columns to ``n_class``. ``log_softmax`` ends it
    (the reference's GraphSAGE, ``sageconv.py:86-114``)."""

    def __init__(self, in_features: int, hidden: int, n_class: int, n_layers: int = 2,
                 aggregator: str = "mean", combine: str = "concat",
                 dropout: float = 0.5, dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        grow = 2 if combine == "concat" else 1
        convs = []
        for i in range(n_layers):
            feats = n_class if i == n_layers - 1 else hidden
            convs.append(SAGEConv(in_features, feats, aggregator, combine, dtype=dtype,
                                  device=device, generator=generator))
            in_features = feats * grow
        self.convs = nn.ModuleList(convs)
        self.out_proj = None
        if combine == "concat":
            self.out_proj = nn.Linear(in_features, n_class, device=device)
            lecun_normal_(self.out_proj.weight, generator)
            nn.init.zeros_(self.out_proj.bias)
        self.dropout, self.dtype = dropout, dtype

    def forward(self, g, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        gs = _layer_inputs(g, len(self.convs))
        for conv, gi in zip(self.convs[:-1], gs):
            x = torch.relu(conv(gi, x))
            if self.training:
                x = _dropout(x, self.dropout, generator)
        x = self.convs[-1](gs[-1], x)
        if self.out_proj is not None:
            x = _dense(self.out_proj, x, self.dtype)
        return torch.log_softmax(x, dim=-1)


def gcnii_beta(lamda: float, layer: int) -> float:
    """GCNII's identity-mapping weight of layer ``layer`` (from 1):
    ``ln(lamda / layer + 1)``."""
    return math.log(lamda / layer + 1.0)


class GCNII(nn.Module):
    """GCNII (Chen et al., "Simple and Deep Graph Convolutional Networks", ICML 2020;
    the authors' ``model.py`` ``GCNII``, not the starred variant):

        h0 = ReLU(dropout(x) W_in + b_in)                        (fcs.0)
        h  = ReLU(GCN2Conv_l(dropout(h), h0)),  l = 1 .. n_layers
        out = log_softmax(dropout(h) W_out + b_out)              (fcs.1)

    with ``beta_l = ln(lamda / l + 1)`` the identity mapping's weight of layer ``l``
    and ``alpha`` the initial residual's (``GCN2Conv``). In training mode dropout
    ``dropout`` applies where shown, its masks drawn from the generator passed to
    ``forward`` in that order: the input, each layer, the head. Full graphs only,
    float32. ``fcs`` are drawn as ``nn.Linear`` draws them (uniform on
    ``±1/sqrt(in)``, the authors' default), on the CPU from ``generator``.

    Each ``GCN2Conv`` applies its layer's ReLU and the next dropout itself (after the
    last layer, the head's), from uniforms this model draws with one ``torch.rand`` a
    mask in the same order; at a dropout that keeps nothing it draws none, as
    ``_dropout`` draws none."""

    def __init__(self, in_features: int, hidden: int, n_class: int, n_layers: int = 64,
                 alpha: float = 0.1, lamda: float = 0.5, dropout: float = 0.6,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convs = nn.ModuleList(
            GCN2Conv(hidden, alpha, gcnii_beta(lamda, i + 1), device=device,
                     generator=generator)
            for i in range(n_layers)
        )
        self.fcs = nn.ModuleList([nn.Linear(in_features, hidden, device=device),
                                  nn.Linear(hidden, n_class, device=device)])
        for fc in self.fcs:
            bound = 1.0 / math.sqrt(fc.in_features)
            uniform_(fc.weight, bound, generator)
            uniform_(fc.bias, bound, generator)
        self.dropout = dropout

    def _drop(self, x: torch.Tensor, generator: Optional[torch.Generator]):
        return _dropout(x, self.dropout, generator) if self.training else x

    def forward(self, g, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not isinstance(g, Graph):
            raise ValueError("GCNII trains on a full Graph (--samp_type full), not on "
                             "sampled blocks")
        h0 = torch.relu(self.fcs[0](self._drop(x, generator)))
        keep = 1.0 - self.dropout if self.training else 1.0
        h = self._drop(h0, generator)
        for conv in self.convs:
            # the uniforms of the next layer's mask (after the last, the head's)
            u = (torch.rand(h0.shape, generator=generator, device=h0.device)
                 if 0.0 < keep < 1.0 else None)
            h = conv(g, h, h0, u, keep)
        return torch.log_softmax(self.fcs[1](h), dim=-1)


class GINNode(nn.Module):
    """Node classification with ``n_layers`` GINConvs (the CLI's ``--Model GIN``):
    ReLU GINConvs with dropout after each, then a GINConv of ``n_class`` without an
    activation, and ``log_softmax``."""

    def __init__(self, in_features: int, hidden: int, n_class: int, n_layers: int = 2,
                 learn_eps: bool = False, dropout: float = 0.5,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_features] + [hidden] * (n_layers - 1) + [n_class]
        self.convs = nn.ModuleList(
            GINConv(dims[i], dims[i + 1], learn_eps=learn_eps,
                    activation=None if i == n_layers - 1 else torch.relu, dtype=dtype,
                    device=device, generator=generator)
            for i in range(n_layers)
        )
        self.dropout = dropout

    def forward(self, g, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        gs = _layer_inputs(g, len(self.convs))
        for conv, gi in zip(self.convs[:-1], gs):
            x = conv(gi, x)
            if self.training:
                x = _dropout(x, self.dropout, generator)
        x = self.convs[-1](gs[-1], x)
        return torch.log_softmax(x, dim=-1)


class GIN(nn.Module):
    """Graph classification: ``n_layers`` ReLU GINConvs on one batched graph; the
    readout pools the input and every layer's output per graph (``pooling``, one
    kind or several concatenated), concatenates them, applies dropout and a Dense
    layer (``readout``), then ``log_softmax``: ``[n_graph, n_class]``."""

    def __init__(self, in_features: int, hidden: int, n_class: int, n_layers: int = 3,
                 learn_eps: bool = False, pooling: Tuple[str, ...] = ("sum",),
                 dropout: float = 0.5, dtype: Optional[torch.dtype] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convs = nn.ModuleList(
            GINConv(in_features if i == 0 else hidden, hidden, learn_eps=learn_eps,
                    dtype=dtype, device=device, generator=generator)
            for i in range(n_layers)
        )
        self.pool = Pooling(tuple(pooling))
        width = len(self.pool.kinds) * (in_features + n_layers * hidden)
        self.readout = nn.Linear(width, n_class, device=device)
        lecun_normal_(self.readout.weight, generator)
        nn.init.zeros_(self.readout.bias)
        self.dropout, self.dtype = dropout, dtype

    def forward(self, g, x: torch.Tensor, graph_id: torch.Tensor, n_graph: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        readouts = [self.pool(x, graph_id, n_graph)]
        for conv in self.convs:
            x = conv(g, x)
            readouts.append(self.pool(x, graph_id, n_graph))
        h = torch.cat(readouts, dim=-1)
        if self.training:
            h = _dropout(h, self.dropout, generator)
        return torch.log_softmax(_dense(self.readout, h, self.dtype), dim=-1)
