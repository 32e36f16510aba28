"""GCNII (Chen, Wei, Huang, Ding and Li, "Simple and Deep Graph Convolutional
Networks", ICML 2020, arXiv 2007.02133; the authors' ``model.py`` ``GCNII``, not the
starred variant), in plain PyTorch, full graphs only:

    h0  = ReLU(dropout(x) W_in^T + b_in)                          (fcs.0)
    s   = (1 - alpha) P dropout(h_{l-1}) + alpha h0               (initial residual)
    h_l = ReLU(beta_l s W_l + (1 - beta_l) s),  beta_l = ln(lamda / l + 1)
    out = log_softmax(dropout(h_L) W_out^T + b_out)               (fcs.1)

with ``P = D^-1/2 (A + I) D^-1/2``: the graph's edges (a self-loop a node among
them) weighed ``dinv[dst] dinv[src]``, ``dinv = deg^-1/2`` of the in-degree over the
edges, computed in float64 and stored in float32; ``P h`` is an ``index_add`` of the
weighed source rows into their destinations. ``W_l`` is ``[hidden, hidden]`` and
multiplies on the right (the paper's ``H W``); the convolutions have no bias.
Dropout masks are drawn in the model's order: the input, each layer, the head.

The parameters are named as the port's ``GCNII`` names them (``specs``).
"""
from __future__ import annotations

import math
from typing import List

import torch

from gnnbench.reference import dropout

# the configuration's keys that both sides read (``arch/gcnii.py``, the optimizer and
# this module), and those whose one value both build (``refuse_unbuilt``)
READS = ("n_layers", "hidden", "alpha", "lamda", "dropout", "lr", "weight_decay")
FIXED = {"dtype": "float32"}


def beta(cfg: dict, layer: int) -> float:
    """The identity mapping's weight of layer ``layer`` (from 1)."""
    return math.log(cfg["lamda"] / layer + 1.0)


def specs(cfg: dict, n_feat: int, n_class: int) -> List[tuple]:
    """``(name, shape, init)`` of every parameter, in the order the model uses them."""
    hid = cfg["hidden"]
    out = [("fcs.0.weight", (hid, n_feat), "fan_in"), ("fcs.0.bias", (hid,), "zeros")]
    out += [(f"convs.{i}.weight", (hid, hid), "fan_in") for i in range(cfg["n_layers"])]
    out += [("fcs.1.weight", (n_class, hid), "fan_in"), ("fcs.1.bias", (n_class,), "zeros")]
    return out


def forward_full(cfg: dict, p, g, x: torch.Tensor, gen) -> torch.Tensor:
    """``g``: ``src``, ``dst`` (int64) and ``n_node``; every node has its self-loop
    among the edges."""
    n, rate, alpha = g.n_node, cfg["dropout"], cfg["alpha"]
    deg = torch.zeros(n, dtype=torch.float64, device=x.device).index_add_(
        0, g.dst, torch.ones(g.dst.numel(), dtype=torch.float64, device=x.device))
    dinv = 1.0 / deg.clamp_min(1.0).sqrt()
    w = (dinv[g.dst] * dinv[g.src]).float()[:, None]
    del deg, dinv
    h0 = torch.relu(dropout(x, rate, gen) @ p["fcs.0.weight"].T + p["fcs.0.bias"])
    h = h0
    for i in range(cfg["n_layers"]):
        h = dropout(h, rate, gen)
        prop = torch.zeros(n, h.shape[1], device=x.device).index_add(
            0, g.dst, h.index_select(0, g.src) * w)
        s = (1.0 - alpha) * prop + alpha * h0
        b = beta(cfg, i + 1)
        h = torch.relu(b * (s @ p[f"convs.{i}.weight"]) + (1.0 - b) * s)
    h = dropout(h, rate, gen)
    return torch.log_softmax(h @ p["fcs.1.weight"].T + p["fcs.1.bias"], dim=-1)


def train_flops(cfg: dict, n_feat: int, n_class: int, rows: List[tuple]) -> float:
    """Operations of one training step (3x the forward): the two dense layers and each
    layer's ``s W_l`` at 2 operations a multiply-add, and each layer's propagation, a
    multiply-add a feature and edge; ``rows[i] = (destinations, input rows, edges)``
    of layer ``i``. The residual mix, the identity mapping's sum, ReLU, dropout, the
    softmax, the loss and Adam are not counted."""
    hid, n = cfg["hidden"], rows[0][0]
    fwd = 2.0 * n * n_feat * hid + 2.0 * n * hid * n_class
    for n_dst, _, n_edge in rows:
        fwd += 2.0 * n_dst * hid * hid + 2.0 * n_edge * hid
    return 3.0 * fwd
