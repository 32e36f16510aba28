"""End-to-end models. Counterpart of ``dgll_tpu/nn/models.py``; the port holds
``GCN``, ``GAT`` and ``GraphSAGE``.

A model's ``forward`` takes one message graph for every layer (full batch) or a list
of sampled ``Block``s, one per layer, outermost first (minibatch), as the neighbour
samplers emit them."""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from dgll_tpu_torch.nn.conv import GATConv, GCNConv, SAGEConv, _dense, lecun_normal_


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
    generator passed to ``forward``."""

    def __init__(self, in_features: int, hidden: int, n_class: int, num_heads: int = 8,
                 n_layers: int = 2, dropout: float = 0.6, negative_slope: float = 0.2,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        convs = []
        for _ in range(n_layers - 1):
            convs.append(GATConv(in_features, hidden, num_heads, concat_heads=True,
                                 negative_slope=negative_slope, attn_dropout=dropout,
                                 device=device, generator=generator))
            in_features = hidden * num_heads
        convs.append(GATConv(in_features, n_class, 1, concat_heads=False,
                             negative_slope=negative_slope, device=device,
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
