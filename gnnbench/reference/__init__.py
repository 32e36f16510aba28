"""The plain reference: what a training step of a cell must compute, in plain PyTorch.

Nothing here imports the program: the models are written out in ``graphsage.py`` and
``gat.py``, and this module holds what they share, each a frozen copy of the rule it
names so that the reference works out again, from the inputs the benchmark made,
what the program derives from them:

* ``sample_blocks``: the device sampler's block-window rule (an anchor slot uniform
  over a node's in-edges and every draw uniform over the valid slots of the anchor's
  128-slot window), in its float32 arithmetic, on the benchmark's CSR and uniforms;
* ``dropout``, ``attention_keep``: the draw rule of dropout masks (one ``torch.rand``
  a mask on the step's generator, kept where below ``1 - rate``, kept values scaled
  by ``1 / (1 - rate)``), drawn in the model's order;
* ``nll``: the mean negative log-likelihood over the masked rows;
* ``Adam``: Adam, and with ``decoupled`` AdamW, by the published update.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

WINDOW = 128  # slots of the CSR's source array a block-window draw reads from
# keys of a configuration file that say where it comes from and what was cut
ABOUT = ("name", "arch", "source", "reduced", "assumed")


def refuse_unbuilt(cfg: dict, reads, fixed: dict) -> None:
    """Raise where configuration ``cfg`` states what no run does: a key that neither
    side reads (``reads``: the keys that both the port's builder and the reference
    take), or a value other than the one both sides build of a key in ``fixed``
    (such as ``dtype`` float32: the port builds its default, the reference computes
    in it)."""
    unknown = sorted(set(cfg) - set(reads) - set(fixed) - set(ABOUT))
    other = {k: cfg[k] for k in fixed if k in cfg and cfg[k] != fixed[k]}
    if unknown or other:
        raise ValueError(f"configuration {cfg.get('name')!r}: keys no run reads {unknown}, "
                         f"values no run builds {other} (built: {fixed})")


@dataclass
class Block:
    """A sampled layer: ``src_ids = [dst_ids | sampled]``, the j-th draw of
    destination i at source slot ``n_dst + i * fanout + j``."""

    dst_ids: torch.Tensor
    src_ids: torch.Tensor
    neigh_mask: torch.Tensor  # [n_dst, fanout]
    dst_mask: torch.Tensor    # [n_dst]
    fanout: int
    n_dst: int


def sample_layer(indptr: torch.Tensor, csr_src: torch.Tensor, frontier: torch.Tensor,
                 fmask: torch.Tensor, fanout: int, draws):
    """``(ids [n, fanout] int32, valid [n, fanout])`` from ``draws = (anchor uniforms
    [n], slot uniforms [n, fanout])``; a masked row, or a row without in-edges, gives
    its own id, not valid."""
    n = frontier.shape[0]
    n_edge = csr_src.numel()
    if n_edge == 0:
        return (frontier[:, None].expand(n, fanout).contiguous(),
                torch.zeros((n, fanout), dtype=torch.bool, device=frontier.device))
    last = n_edge - 1
    safe = torch.where(fmask, frontier, 0).long()
    start = indptr[safe].long()
    deg = indptr[safe + 1].long() - start
    ok = fmask & (deg > 0)
    degf = deg.clamp_min(1).to(torch.float32)
    ua, ul = draws
    anchor = torch.clamp_max(start + (ua * degf).long(), last)
    base = anchor // WINDOW * WINDOW
    lo = torch.clamp_min(start - base, 0)
    hi = torch.clamp_max(start + deg - base, WINDOW)
    span = torch.clamp_min(hi - lo, 1).to(torch.float32)
    idx = torch.clamp_max(base[:, None] + lo[:, None] + (ul * span[:, None]).long(), last)
    sampled = csr_src[idx.reshape(-1)].reshape(n, fanout).to(torch.int32)
    valid = ok[:, None].expand(n, fanout)
    return torch.where(valid, sampled, frontier[:, None]), valid.contiguous()


def sample_blocks(indptr, csr_src, seeds, seed_mask, fanouts: List[int],
                  draws) -> List[Block]:
    """Blocks outermost first; ``draws[li]`` are layer ``li``'s uniforms, innermost
    (the seeds' layer) first."""
    frontier, fmask = seeds.to(torch.int32), seed_mask
    blocks: List[Block] = []
    for li, f in enumerate(reversed(list(fanouts))):
        sampled, smask = sample_layer(indptr, csr_src, frontier, fmask, int(f), draws[li])
        src_ids = torch.cat([frontier, sampled.reshape(-1)])
        blocks.insert(0, Block(frontier, src_ids, smask, fmask, int(f), frontier.shape[0]))
        frontier, fmask = src_ids, torch.cat([fmask, smask.reshape(-1)])
    return blocks


def dropout(x: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout with its mask drawn from ``gen``."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def attention_keep(shape, rate: float, gen: Optional[torch.Generator], device):
    """The attention dropout's factor: 0 or ``1 / (1 - rate)``, or None at rate 0."""
    if rate == 0.0:
        return None
    keep = 1.0 - rate
    return (torch.rand(shape, generator=gen, device=device) < keep).float() / keep


def leaky_relu(z: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(z >= 0, z, slope * z)


def nll(logp: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the rows where ``mask`` holds."""
    picked = logp.gather(1, labels.long()[:, None])[:, 0]
    m = mask.to(picked.dtype)
    return -(picked * m).sum() / m.sum().clamp_min(1.0)


class Adam:
    """Adam (Kingma and Ba, 2015) on a dict of leaves; ``decoupled``: AdamW's weight
    decay (Loshchilov and Hutter, 2019), ``p *= 1 - lr * wd`` before the update."""

    def __init__(self, lr: float, weight_decay: float = 0.0, decoupled: bool = False,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.decoupled = lr, weight_decay, decoupled
        self.b1, self.b2, self.eps = betas[0], betas[1], eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            if self.wd and not self.decoupled:
                g = g + self.wd * p
            if self.wd and self.decoupled:
                p.mul_(1 - self.lr * self.wd)
            m = self.m.setdefault(k, torch.zeros_like(p))
            v = self.v.setdefault(k, torch.zeros_like(p))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
