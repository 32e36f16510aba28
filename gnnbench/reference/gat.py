"""GAT (Velickovic et al., ICLR 2018), in plain PyTorch.

Hidden layers: ``heads`` heads of ``hidden`` features, ``e = LeakyReLU(a_src . h[src]
+ a_dst . h[dst])`` per edge and head, a softmax over each destination's in-edges,
the alpha-weighted sum of ``h[src]``, heads concatenated, ELU. The output layer has
one head of ``n_class`` features (its mean over heads is that head). Dropout
``dropout`` applies to the features before every layer and to the hidden layers'
attention; masks are drawn in that order (features, then attention, layer by layer).

On a full graph the edges are taken in the order of (destination, source), so that
the attention mask's row ``k`` belongs to the k-th edge in that order. On a sampled
block a destination attends over its ``fanout`` draws, masked draws left out.

The parameters are named as the port's ``GAT`` names them (``specs``).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from gnnbench.reference import attention_keep, dropout, leaky_relu

# the configuration's keys that both sides read (``arch/gat.py``, the optimizer and
# this module), and those whose one value both build (``refuse_unbuilt``)
READS = ("n_layers", "heads", "hidden", "dropout", "negative_slope", "lr", "weight_decay")
FIXED = {"out_heads": 1, "activation": "elu", "dtype": "float32"}


def layers(cfg: dict, n_feat: int, n_class: int) -> List[tuple]:
    """``(in, heads, features, attention dropout)`` of each layer."""
    out, d = [], n_feat
    for _ in range(cfg["n_layers"] - 1):
        out.append((d, cfg["heads"], cfg["hidden"], cfg["dropout"]))
        d = cfg["heads"] * cfg["hidden"]
    out.append((d, 1, n_class, 0.0))
    return out


def specs(cfg: dict, n_feat: int, n_class: int) -> List[tuple]:
    out = []
    for i, (fin, h, f, _) in enumerate(layers(cfg, n_feat, n_class)):
        out += [(f"convs.{i}.linear.weight", (h * f, fin), "fan_in"),
                (f"convs.{i}.attn_src", (h, f), "glorot"),
                (f"convs.{i}.attn_dst", (h, f), "glorot")]
    return out


def _scores(p: Dict[str, torch.Tensor], i: int, h3: torch.Tensor):
    return ((h3 * p[f"convs.{i}.attn_src"]).sum(-1), (h3 * p[f"convs.{i}.attn_dst"]).sum(-1))


def forward_full(cfg: dict, p, g, x: torch.Tensor, gen) -> torch.Tensor:
    """``g``: ``src``, ``dst`` (int64, sorted by destination, then source) and
    ``n_node``."""
    n, slope = g.n_node, cfg["negative_slope"]
    ls = layers(cfg, x.shape[1], 0)
    for i, (_, heads, f, attn_rate) in enumerate(ls):
        x = dropout(x, cfg["dropout"], gen)
        h3 = (x @ p[f"convs.{i}.linear.weight"].T).view(n, heads, -1)
        s_src, s_dst = _scores(p, i, h3)
        e = leaky_relu(s_src[g.src] + s_dst[g.dst], slope)                 # [E, H]
        m = torch.full_like(s_dst, float("-inf")).scatter_reduce(
            0, g.dst[:, None].expand_as(e), e, "amax").detach()
        ex = torch.exp(e - m[g.dst])
        den = torch.zeros_like(s_dst).index_add(0, g.dst, ex)
        alpha = ex / den[g.dst]
        keep = attention_keep(alpha.shape, attn_rate, gen, x.device)
        if keep is not None:
            alpha = alpha * keep
        out = torch.zeros_like(h3).index_add(0, g.dst, h3[g.src] * alpha[:, :, None])
        if i < len(ls) - 1:
            x = torch.nn.functional.elu(out.reshape(n, -1))
        else:
            x = out.mean(1)
    return torch.log_softmax(x, dim=-1)


def forward_blocks(cfg: dict, p, blocks, x: torch.Tensor, gen) -> torch.Tensor:
    slope = cfg["negative_slope"]
    ls = layers(cfg, x.shape[1], 0)
    for i, ((_, heads, f, attn_rate), b) in enumerate(zip(ls, blocks)):
        x = dropout(x, cfg["dropout"], gen)
        h3 = (x @ p[f"convs.{i}.linear.weight"].T).view(x.shape[0], heads, -1)
        s_src, s_dst = _scores(p, i, h3)
        nd, fo = b.n_dst, b.fanout
        neigh = h3[nd: nd * (1 + fo)].reshape(nd, fo, heads, -1)
        e = leaky_relu(s_dst[:nd, None, :] + s_src[nd: nd * (1 + fo)].reshape(nd, fo, heads),
                       slope)
        m = b.neigh_mask[..., None]
        e = torch.where(m, e, -1e9)
        ex = torch.exp(e - e.amax(dim=1, keepdim=True).detach()) * m
        alpha = ex / ex.sum(dim=1, keepdim=True).clamp_min(1e-9)             # [nd, fo, H]
        keep = attention_keep(alpha.shape, attn_rate, gen, x.device)
        if keep is not None:
            alpha = alpha * keep
        out = (alpha[..., None] * neigh).sum(1)                              # [nd, H, F]
        if i < len(ls) - 1:
            x = torch.nn.functional.elu(out.reshape(nd, -1))
        else:
            x = out.mean(1)
    return torch.log_softmax(x, dim=-1)


def train_flops(cfg: dict, n_feat: int, n_class: int, rows: List[tuple]) -> float:
    """Operations of one training step (3x the forward): each layer's projection of its
    input rows, the two per-node score dots, and per edge and head the weighted sum
    of the source's features (a multiply-add a feature); ``rows[i] = (destinations,
    input rows, edges)`` of layer ``i``. The softmax, LeakyReLU, ELU, dropout, the
    loss and Adam are not counted."""
    fwd = 0.0
    for (fin, h, f, _), (_, n_in, n_edge) in zip(layers(cfg, n_feat, n_class), rows):
        fwd += 2.0 * n_in * fin * h * f + 2.0 * 2 * n_in * h * f + 2.0 * n_edge * h * f
    return 3.0 * fwd


def k1_sums(cfg: dict, n_feat: int, n_class: int) -> List[tuple]:
    """The port's fused GAT layer sums its per-edge messages twice a layer and step
    (the forward aggregation on A, the backward scatter on A^T read through a column
    permutation): ``(width, permuted)`` of each sum of one step."""
    return [(h * f, perm) for (_, h, f, _) in layers(cfg, n_feat, n_class)
            for perm in (False, True)]


def attention_heads(cfg: dict, n_feat: int, n_class: int) -> List[tuple]:
    """``(heads, width)`` of each layer whose attention runs on the port's row
    kernels (K3-K7) in a full-graph step."""
    return [(h, h * f) for (_, h, f, _) in layers(cfg, n_feat, n_class)]
