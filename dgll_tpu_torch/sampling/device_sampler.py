"""On-device neighbour sampling: the CSR lives in device memory and a fanout sample
is a few gathers on the card, with no host work and no copy per batch.

Counterpart of ``dgll_tpu/sampling/device_sampler.py``. The JAX package stores its
tables packed as ``[ceil(n/128), 128]`` and reads a scalar as a row gather plus a
one-hot lane select (``pack_1d``/``take_packed``), because XLA on the TPU lowers a
gather of scalars badly. On the GPU a scalar gather is an ``index_select``, so the
tables here are flat int32 tensors and ``src[idx]`` is read directly.

The semantics are the JAX package's, float32 arithmetic included, so that the same
uniforms give the same ids: with-replacement uniform fanout over in-edges, masked
fallback to self for zero-degree and padded rows, and blocks emitted outermost
first in the ``src_ids = [dst_ids | sampled]`` layout of ``Block``.

Block-window mode keeps the JAX package's 128-slot windows: a window is a
128-aligned run of the CSR's ``src`` array (``WINDOW``), and the ids drawn depend on
it, so it is part of the function, not of the layout. Each frontier node draws one
anchor slot uniformly over its edge range, and all its ``fanout`` draws come
uniformly from the valid slots of the anchor's window: each draw's marginal is
exactly uniform over the node's neighbours, and draws within a node are correlated.

Randomness enters only as uniforms: ``sample_layer_device`` takes a
``torch.Generator`` or the uniforms themselves (``draws``), and is then a pure
function of its inputs. The tests hand it the JAX package's uniforms.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dgll_tpu_torch.sampling.base import Block

WINDOW = 128  # slots of the CSR's src array a block-window draw reads from


@dataclass
class DeviceCSR:
    """Device-resident in-edge CSR (the sampling view of a ``Graph``).

    ``indptr[v]:indptr[v+1]`` spans the in-edges of ``v``; ``src[k]`` is the
    neighbour a message arrives from. Both are flat int32 tensors on the device.
    """

    indptr: torch.Tensor   # [n_node + 1] int32
    src: torch.Tensor      # [n_edge] int32
    n_node: int = 0
    n_edge: int = 0

    @staticmethod
    def from_graph(g, device="cuda") -> "DeviceCSR":
        """From a ``Graph``: its real nodes and real edges only."""
        indptr = g.indptr.cpu().numpy().astype(np.int64)[: g.n_real_node + 1].copy()
        indptr[-1] = min(int(indptr[-1]), g.n_real_edge)
        return DeviceCSR.from_host_arrays(indptr, g.src.cpu().numpy()[: g.n_real_edge],
                                          device)

    @staticmethod
    def from_host_arrays(indptr, src, device="cuda") -> "DeviceCSR":
        indptr = np.asarray(indptr)
        src = np.asarray(src)
        if len(src) > np.iinfo(np.int32).max:
            raise ValueError("DeviceCSR is int32; graph exceeds 2^31 edges")
        dev = torch.device(device)
        return DeviceCSR(
            indptr=torch.from_numpy(indptr.astype(np.int32)).to(dev),
            src=torch.from_numpy(src.astype(np.int32)).to(dev),
            n_node=int(len(indptr) - 1),
            n_edge=int(len(src)),
        )

    @property
    def device(self) -> torch.device:
        return self.indptr.device


def layer_sizes(batch_size: int, fanouts: Sequence[int]) -> List[int]:
    """Frontier length at each layer of a sample, innermost (seed side) first: the
    rows whose neighbours layer ``li`` draws (``fanouts`` in model order)."""
    sizes = [int(batch_size)]
    for f in reversed(list(fanouts)[1:]):
        sizes.append(sizes[-1] * (1 + int(f)))
    return sizes


def draw_uniforms(n: int, fanout: int, window: bool, generator=None, device=None,
                  lead: Tuple[int, ...] = ()):
    """The uniforms one layer of ``n`` frontier rows reads, with leading dimensions
    ``lead``: ``u [*lead, n, fanout]``, or in window mode ``(ua [*lead, n], ul [*lead,
    n, fanout])``; one ``torch.rand`` call a tensor."""
    def rand(*shape):
        return torch.rand(*lead, *shape, generator=generator, device=device)

    if window:
        return rand(n), rand(n, fanout)
    return rand(n, fanout)


def sample_layer_device(
    csr: DeviceCSR,
    frontier: torch.Tensor,   # [n] int32 global ids
    fmask: torch.Tensor,      # [n] bool
    fanout: int,
    generator: Optional[torch.Generator] = None,
    draws=None,
    window: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[n, fanout]`` with-replacement uniform in-neighbour sample and its mask.

    Invalid rows (masked, or of degree 0) emit the row's own id with mask 0. Every
    index is clamped into the tables before it is read, so an invalid row reads no
    slot out of bounds. ``draws`` are the uniforms (``draw_uniforms``' layout); where
    they are None they are drawn from ``generator``.
    """
    n = frontier.shape[0]
    frontier = frontier.to(torch.int32)
    if draws is None:
        draws = draw_uniforms(n, fanout, window, generator, frontier.device)
    if csr.n_edge == 0:  # nothing to draw from: every row is its own id
        return (frontier[:, None].expand(n, fanout).contiguous(),
                torch.zeros((n, fanout), dtype=torch.bool, device=frontier.device))
    last = csr.n_edge - 1
    safe = torch.where(fmask, frontier, 0)
    start = csr.indptr.index_select(0, safe)
    deg = csr.indptr.index_select(0, safe + 1) - start
    ok = fmask & (deg > 0)
    degf = deg.clamp_min(1).to(torch.float32)
    if not window:
        off = (draws * degf[:, None]).to(torch.int32)
        idx = torch.clamp_max(start[:, None] + off, last)
    else:
        ua, ul = draws
        anchor = torch.clamp_max(start + (ua * degf).to(torch.int32), last)
        base = anchor // WINDOW * WINDOW
        lo = torch.clamp_min(start - base, 0)                  # first valid slot
        hi = torch.clamp_max(start + deg - base, WINDOW)       # one past the last
        span = torch.clamp_min(hi - lo, 1).to(torch.float32)
        lane = lo[:, None] + (ul * span[:, None]).to(torch.int32)
        idx = torch.clamp_max(base[:, None] + lane, last)
    sampled = csr.src.index_select(0, idx.reshape(-1)).reshape(n, fanout)
    valid = ok[:, None].expand(n, fanout)
    return torch.where(valid, sampled, frontier[:, None]), valid.contiguous()


def sample_blocks_device(
    csr: DeviceCSR,
    seeds: torch.Tensor,       # [b] global ids (padded entries allowed)
    seed_mask: torch.Tensor,   # [b] bool
    fanouts: Sequence[int],
    generator: Optional[torch.Generator] = None,
    draws=None,
    window: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, List[Block]]:
    """Multi-layer block sampling on the device (``NeighborSampler.sample``'s
    function): ``(input_nodes, output_nodes, blocks)``, blocks outermost first, every
    shape a static function of ``(len(seeds), fanouts)``.

    ``draws[li]`` are layer ``li``'s uniforms, innermost layer first (the JAX
    package's ``fold_in(key, li)`` order); where ``draws`` is None each layer draws
    from ``generator``.
    """
    seeds = seeds.to(torch.int32)
    frontier, fmask = seeds, seed_mask
    blocks: List[Block] = []
    for li, fanout in enumerate(reversed(list(fanouts))):
        sampled, smask = sample_layer_device(
            csr, frontier, fmask, int(fanout), generator,
            None if draws is None else draws[li], window=window)
        src_ids = torch.cat([frontier, sampled.reshape(-1)])
        blocks.insert(0, Block(dst_ids=frontier, src_ids=src_ids, neigh_mask=smask,
                               dst_mask=fmask, fanout=int(fanout),
                               n_dst=int(frontier.shape[0])))
        frontier = src_ids
        fmask = torch.cat([fmask, smask.reshape(-1)])
    input_nodes = blocks[0].src_ids if blocks else seeds
    return input_nodes, seeds, blocks


class DeviceNeighborSampler:
    """Object-style wrapper with the ``BaseSampler`` call shape, sampling on the
    CSR's device from ``generator`` (or from the uniforms ``draws``)."""

    def __init__(self, fanouts: Sequence[int], window: bool = False):
        self.fanouts = [int(f) for f in fanouts]
        self.window = bool(window)

    def sample(self, csr: DeviceCSR, seeds, generator=None, seed_mask=None, draws=None):
        seeds = torch.as_tensor(np.asarray(seeds), dtype=torch.int32).to(csr.device)
        if seed_mask is None:
            seed_mask = torch.ones(seeds.shape, dtype=torch.bool, device=csr.device)
        return sample_blocks_device(csr, seeds, seed_mask, self.fanouts, generator,
                                    draws, window=self.window)
