"""GraphSAGE (Hamilton et al., NeurIPS 2017) with the mean aggregator, in plain PyTorch.

Each layer: ``h = [x_self W_self + b | mean(x_neigh) W_neigh]``, ReLU and dropout
between layers; the last layer's ``2 * n_class`` columns go through one more dense
layer (``out_proj``) to the classes, then ``log_softmax``. On a sampled block the
neighbours are the block's ``fanout`` draws of each destination; on a full graph
they are its in-neighbours (a row without in-edges has mean 0).

The parameters are named as the port's ``GraphSAGE`` names them, so that the
benchmark hands both the same tensors; ``specs`` lists them.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from gnnbench.reference import dropout

# the configuration's keys that both sides read (``arch/graphsage.py``, the optimizer
# and this module), and those whose one value both build (``refuse_unbuilt``)
READS = ("n_layers", "hidden", "dropout", "lr", "weight_decay")
FIXED = {"aggregator": "mean", "combine": "concat", "dtype": "float32"}


def widths(cfg: dict, n_feat: int, n_class: int) -> List[tuple]:
    """``(in, out)`` of each SAGE layer."""
    out, d = [], n_feat
    for i in range(cfg["n_layers"]):
        f = n_class if i == cfg["n_layers"] - 1 else cfg["hidden"]
        out.append((d, f))
        d = 2 * f
    return out


def specs(cfg: dict, n_feat: int, n_class: int) -> List[tuple]:
    """``(name, shape, init)`` of every parameter, in the port's order."""
    out = []
    for i, (fin, f) in enumerate(widths(cfg, n_feat, n_class)):
        out += [(f"convs.{i}.neigh.weight", (f, fin), "fan_in"),
                (f"convs.{i}.self.weight", (f, fin), "fan_in"),
                (f"convs.{i}.self.bias", (f,), "zeros")]
    out += [("out_proj.weight", (n_class, 2 * n_class), "fan_in"),
            ("out_proj.bias", (n_class,), "zeros")]
    return out


def _layer(p: Dict[str, torch.Tensor], i: int, x_self, agg) -> torch.Tensor:
    h_self = x_self @ p[f"convs.{i}.self.weight"].T + p[f"convs.{i}.self.bias"]
    return torch.cat([h_self, agg @ p[f"convs.{i}.neigh.weight"].T], dim=-1)


def _head(cfg, p, x, i, gen):
    if i < cfg["n_layers"] - 1:
        return dropout(torch.relu(x), cfg["dropout"], gen)
    return torch.log_softmax(x @ p["out_proj.weight"].T + p["out_proj.bias"], dim=-1)


def forward_blocks(cfg: dict, p, blocks, x: torch.Tensor, gen) -> torch.Tensor:
    for i, b in enumerate(blocks):
        agg = x[b.n_dst: b.n_dst * (1 + b.fanout)].reshape(b.n_dst, b.fanout, -1).mean(1)
        x = _head(cfg, p, _layer(p, i, x[: b.n_dst], agg), i, gen)
    return x


def forward_full(cfg: dict, p, g, x: torch.Tensor, gen) -> torch.Tensor:
    """``g``: ``src``, ``dst`` (int64) and ``n_node``."""
    deg = torch.zeros(g.n_node, device=x.device).index_add_(
        0, g.dst, torch.ones(g.dst.numel(), device=x.device)).clamp_min(1)
    for i in range(cfg["n_layers"]):
        tot = torch.zeros(g.n_node, x.shape[1], device=x.device).index_add(
            0, g.dst, x.index_select(0, g.src))
        x = _head(cfg, p, _layer(p, i, x, tot / deg[:, None]), i, gen)
    return x


def train_flops(cfg: dict, n_feat: int, n_class: int, rows: List[tuple]) -> float:
    """Operations of one training step (forward and backward, 3x the forward): the
    dense products at 2 operations a multiply-add and the mean's additions, layer by
    layer; ``rows[i] = (destinations, input rows, messages)`` of layer ``i``.
    Elementwise work (ReLU, dropout, the softmax, the loss, Adam) is not counted."""
    fwd = 0.0
    for (fin, f), (n_dst, _, n_msg) in zip(widths(cfg, n_feat, n_class), rows):
        fwd += 2.0 * 2 * n_dst * fin * f + n_msg * fin
    fwd += 2.0 * rows[-1][0] * 2 * n_class * n_class
    return 3.0 * fwd
