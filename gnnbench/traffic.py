"""Traffic: a cell's graph, features, labels and train nodes, made on the device from
the seed by one general generator that reads a traffic file (``traffic/<name>.json``).

The graph is the power-law rule of the port's headline bench: ``n_pair`` node pairs,
each destination drawn by inverse CDF of ``(v + 1) ** -POWER``, each source uniform
(a pair of a node with itself moves its source on by one), each pair stored both
ways, with one self-loop a node where ``self_loops`` says so. So a traffic file at a
dataset's published sizes has that dataset's edge count exactly.
Features are standard normal float32, labels uniform over the classes, and the train
nodes ``n_train`` distinct nodes. Every draw is one call on a ``torch.Generator`` of
the data's device, so one seed gives the same data on every run.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
# the names of the independent streams a run draws from its seed
STREAMS = ("graph", "features", "weights", "check", "program")
POWER = 0.9  # the degree law's exponent: destinations by (v + 1) ** -POWER


def streams(seed: int) -> dict:
    """63-bit seeds of ``STREAMS``, derived from the run's ``--seed`` (any whole
    number that numpy's ``SeedSequence`` takes)."""
    state = np.random.SeedSequence(int(seed)).generate_state(len(STREAMS), np.uint64)
    return {name: int(s) >> 1 for name, s in zip(STREAMS, state)}


@dataclass(frozen=True)
class Traffic:
    """A traffic file's parameters. ``mode`` names the driver (``modes/<mode>.py``):
    ``minibatch`` (neighbour sampling on the device, ``batch_size`` seeds a batch,
    ``fanouts`` outermost first, block-window draws) or ``full`` (one full-graph step
    an epoch). A traffic file holds these keys and a ``source``, and no other."""

    name: str
    mode: str
    n_node: int
    n_pair: int
    n_feat: int
    n_class: int
    n_train: int
    self_loops: bool = False
    batch_size: int = 0
    fanouts: tuple = ()

    @property
    def n_edge(self) -> int:
        return 2 * self.n_pair + (self.n_node if self.self_loops else 0)

    def scaled(self, n_node: int = 3000, batch_size: int = 64) -> "Traffic":
        """The same mix at ``n_node`` nodes, for a dry run on the CPU: the average
        degree, the widths, the fanouts and the train share kept."""
        f = min(1.0, n_node / self.n_node)
        return dataclasses.replace(
            self, n_node=min(n_node, self.n_node), n_pair=max(1, round(self.n_pair * f)),
            n_train=max(1, round(self.n_train * f)),
            batch_size=min(self.batch_size, batch_size) if self.batch_size else 0)


def load(name: str, root: Path = HERE) -> Traffic:
    with open(root / "traffic" / f"{name}.json") as fh:
        d = json.load(fh)
    d.pop("source", None)
    unknown = set(d) - {f.name for f in dataclasses.fields(Traffic)}
    if unknown:  # a key the generator would not read states traffic that no run sends
        raise ValueError(f"traffic {name}: keys the generator does not read: {sorted(unknown)}")
    d["fanouts"] = tuple(d.get("fanouts", ()))
    return Traffic(name=name, **d)


@dataclass
class Data:
    """A cell's data on its device. ``src``/``dst`` are the edges (int64) in the
    generator's order; ``indptr``/``csr_src`` the in-edge CSR (stable by that order)
    where the mode samples; ``train_nodes`` int64."""

    traffic: Traffic
    src: Optional[torch.Tensor]
    dst: Optional[torch.Tensor]
    feats: torch.Tensor
    labels: torch.Tensor
    train_nodes: torch.Tensor
    indptr: Optional[torch.Tensor] = None
    csr_src: Optional[torch.Tensor] = None

    @property
    def n_edge(self) -> int:
        return int((self.src if self.src is not None else self.csr_src).numel())


def edges(t: Traffic, seed: int, device) -> tuple:
    """``(src, dst)`` int64 on ``device``: the traffic's graph from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = t.n_node
    w = (torch.arange(n, dtype=torch.float64, device=device) + 1.0) ** -POWER
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(t.n_pair, generator=g, device=device, dtype=torch.float64)
    dst = torch.searchsorted(cdf, u).clamp_max_(n - 1)
    del u
    src = torch.randint(0, n, (t.n_pair,), generator=g, device=device)
    src = torch.where(src == dst, (src + 1) % n, src)
    src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    if t.self_loops:
        loops = torch.arange(n, device=device)
        src, dst = torch.cat([src, loops]), torch.cat([dst, loops])
    return src, dst


def in_csr(src: torch.Tensor, dst: torch.Tensor, n_node: int) -> tuple:
    """``(indptr int64 [n + 1], src int32 [E])``: the in-edge CSR, each row's edges in
    their order in ``src``/``dst``."""
    order = torch.argsort(dst, stable=True)
    csr_src = src.index_select(0, order).to(torch.int32)
    del order
    indptr = torch.zeros(n_node + 1, dtype=torch.int64, device=src.device)
    torch.cumsum(torch.bincount(dst, minlength=n_node), 0, out=indptr[1:])
    return indptr, csr_src


def make(t: Traffic, seeds: dict, device) -> Data:
    """The whole cell's data from the run's ``streams``."""
    src, dst = edges(t, seeds["graph"], device)
    g = torch.Generator(device=device).manual_seed(seeds["features"])
    feats = torch.randn(t.n_node, t.n_feat, generator=g, device=device)
    labels = torch.randint(0, t.n_class, (t.n_node,), generator=g, device=device)
    train = torch.randperm(t.n_node, generator=g, device=device)[: t.n_train]
    data = Data(t, src, dst, feats, labels, train)
    if t.mode == "minibatch":
        data.indptr, data.csr_src = in_csr(src, dst, t.n_node)
        data.src = data.dst = None  # the CSR holds the graph
    return data


def layer_sizes(batch_size: int, fanouts: List[int]) -> List[int]:
    """Frontier rows of each sampled layer, innermost (the seeds) first."""
    sizes = [int(batch_size)]
    for f in reversed(list(fanouts)[1:]):
        sizes.append(sizes[-1] * (1 + int(f)))
    return sizes
