"""Layer-wise importance sampling on the device: FastGCN and LADIES.

Counterpart of ``dgll_tpu/sampling/device_layerwise.py``. The normalised Laplacian
lives in device memory in ELL layout ``[N, K]`` (columns and values), each row
sorted by |value| descending when it is built, so the K-truncation keeps the
heaviest entries, as the host packer's truncation does. Every shape is static and
the step reads no value back to the host, so a batch's sampling can be captured in
a CUDA graph.

* FastGCN draws each layer's ``s`` candidates from the fixed global distribution
  ``p_i ∝ ||L[:, i]||^2`` through a Vose alias table: two table reads a draw.
* LADIES draws ``s`` candidate edges from the previous layer's ELL windows with
  probability ∝ L², by inverse CDF over the flattened window grid
  (``searchsorted`` on the prefix sum); the kept columns have the LADIES marginal
  ``p_j ∝ Σ_{i∈prev} L²[i, j]``.
* Draws are with replacement. Drawn-only columns are rescaled by ``mult / (s p_j)``,
  previous-layer columns keep their exact weight (defensive importance sampling).
* Blocks are ``WeightedBlock``s: every destination keeps its K window slots, each
  mapped to the first source slot of ``src_ids = [prev | drawn]`` holding its column
  (previous-layer columns preferred).

The JAX package stores the 1-D tables packed as ``[ceil(n/128), 128]`` and reads a
scalar as a row gather and a lane select (a TPU workaround); here they are flat
tensors. Randomness enters only as uniforms (``draw_layer_uniforms``): FastGCN reads
two ``[s]`` tensors a layer (the alias slot's and the accept test's, the JAX
package's ``split(fold_in(key, li))``), LADIES one. The tests hand in JAX's.

Where the two packages may differ: LADIES's prefix sum is float32 in XLA and
float64 here, so a pick may differ where its uniform lies within float32 rounding of
a boundary of the prefix sum; and its column weights ``p_j`` are a float64 scatter
into a per-node array here, a float32 einsum over the ``[nK, n_src]`` match there,
equal within float32 rounding. In float64 the card's run-to-run order of additions
(a scan's look-back, atomics) changes neither a pick nor a weight, so a replayed
LADIES step repeats its eager step.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dgll_tpu_torch.sampling.base import WeightedBlock

MODES = ("fastgcn", "ladies")


@dataclass
class DeviceLap:
    """Device-resident normalised Laplacian for layer-wise sampling."""

    ell_col: torch.Tensor     # [N, K] int32 (-1 on padding)
    ell_val: torch.Tensor     # [N, K] float32 Laplacian values (0 on padding)
    pfull: torch.Tensor       # [N] float32 FastGCN column probabilities
    alias_prob: torch.Tensor  # [N] float32 alias acceptance probabilities
    alias_idx: torch.Tensor   # [N] int32 alias fallback indices
    n_node: int = 0
    k: int = 0

    @property
    def device(self) -> torch.device:
        return self.ell_col.device

    def to(self, device) -> "DeviceLap":
        return replace(self, **{f.name: getattr(self, f.name).to(device)
                                for f in fields(self)
                                if isinstance(getattr(self, f.name), torch.Tensor)})


def build_alias_table(p: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vose alias table for O(1) categorical draws: ``(prob float32, alias int64)``,
    the JAX package's table exactly (the same list pops in the same order)."""
    p = np.asarray(p, np.float64)
    n = len(p)
    tot = p.sum()
    if tot <= 0:
        p = np.ones(n)
        tot = float(n)
    scaled = p * (n / tot)
    prob = np.ones(n)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    for i in small + large:
        prob[i] = 1.0
    return prob.astype(np.float32), alias.astype(np.int64)


def build_device_lap(g, k: int = 32, flatten: bool = False, device="cuda") -> DeviceLap:
    """Pack ``D^-1/2 (A+I) D^-1/2`` of a ``Graph`` into the ELL layout (host numpy),
    on ``device``. ``flatten`` bakes FastGCN's ``p <- sqrt(p)`` into the probability
    and alias tables."""
    from dgll_tpu_torch.sampling.layerwise import normalized_laplacian

    lap = normalized_laplacian(g).tocoo()
    n = lap.shape[0]
    # global FastGCN probabilities p_i ∝ ||L[:, i]||^2; bincount adds in array order,
    # as the JAX package's np.add.at does, so the sums are the same bits
    p = np.bincount(lap.col, weights=lap.data.astype(np.float64) ** 2, minlength=n)
    if flatten:
        p = np.sqrt(p)
    pfull = (p / max(p.sum(), 1e-30)).astype(np.float32)

    # ELL rows sorted by |value| descending: the truncation keeps the heaviest edges.
    # The JAX package's np.lexsort((-|v|, row)) as one stable sort of a 64-bit key:
    # the row, then the complement of |v|'s float32 bits (monotone for |v| >= 0), so
    # the order is the same, ties included, at a sixth of the time
    mag = np.abs(lap.data).astype(np.float32).view(np.uint32)
    key = (lap.row.astype(np.uint64) << np.uint64(32)) | \
        (np.uint32(0xFFFFFFFF) - mag).astype(np.uint64)
    order = np.argsort(key, kind="stable")
    row, col, val = lap.row[order], lap.col[order], lap.data[order]
    counts = np.bincount(row, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(row)) - starts[row]
    keep = pos < k
    ell_col = np.full((n, k), -1, np.int32)
    ell_val = np.zeros((n, k), np.float32)
    ell_col[row[keep], pos[keep]] = col[keep]
    ell_val[row[keep], pos[keep]] = val[keep]

    prob, alias = build_alias_table(pfull)
    dev = torch.device(device)
    return DeviceLap(
        ell_col=torch.from_numpy(ell_col).to(dev),
        ell_val=torch.from_numpy(ell_val).to(dev),
        pfull=torch.from_numpy(pfull).to(dev),
        alias_prob=torch.from_numpy(prob).to(dev),
        alias_idx=torch.from_numpy(alias.astype(np.int32)).to(dev),
        n_node=int(n),
        k=int(k),
    )


def draw_layer_uniforms(s: int, mode: str, generator=None, device=None,
                        lead: Tuple[int, ...] = ()):
    """The uniforms one layer of ``s`` draws reads, with leading dimensions ``lead``:
    FastGCN ``(u, accept)``, each ``[*lead, s]``; LADIES ``u [*lead, s]``; one
    ``torch.rand`` call a tensor."""
    def rand():
        return torch.rand(*lead, s, generator=generator, device=device)

    if mode == "fastgcn":
        return rand(), rand()
    return rand()


def alias_draw(lap: DeviceLap, u: torch.Tensor, accept: torch.Tensor) -> torch.Tensor:
    """``len(u)`` i.i.d. draws from the FastGCN distribution: the slot
    ``min(int(u n), n - 1)``, kept where ``accept`` is below its acceptance
    probability, else its alias."""
    slot = torch.clamp_max((u * lap.n_node).to(torch.int32), lap.n_node - 1)
    keep = accept < lap.alias_prob.index_select(0, slot)
    return torch.where(keep, slot, lap.alias_idx.index_select(0, slot))


def _layer(lap: DeviceLap, prev_ids: torch.Tensor, prev_mask: torch.Tensor, s: int,
           draws, mode: str) -> WeightedBlock:
    """One layer: draw ``s`` columns, then build the weighted block.

    The JAX package matches window edges to source slots by comparing every edge
    with every slot, an ``[n_prev K, n_prev + s]`` boolean tensor (268 MB at 2,048
    rows, K 32 and s 2,048). Here a stable sort of the ``n_prev + s`` slot ids and
    two binary searches an edge give the same first slot, previous-layer flag and
    multiplicity."""
    n_prev = int(prev_ids.shape[0])
    K = lap.k
    safe = torch.where(prev_mask, prev_ids, 0).to(torch.int32)
    cols = lap.ell_col.index_select(0, safe)            # [n_prev, K]
    vals = lap.ell_val.index_select(0, safe)            # [n_prev, K]
    valid = (cols >= 0) & prev_mask[:, None]
    vals = torch.where(valid, vals, 0.0)
    cand = torch.where(valid, cols, -1).reshape(-1)     # [nK] global ids (-1 pad)
    nK = cand.shape[0]

    if mode == "fastgcn":
        drawn = alias_draw(lap, *draws)                 # [s]
    else:  # LADIES: draw edges ∝ L² over the window grid (column marginal p_j)
        w2 = (vals * vals).reshape(-1)                  # [nK]
        # the prefix sum (and the column sums below) in float64: on the card both
        # add in an order that may change from run to run (a scan's look-back,
        # atomics), which in float64 moves no pick and no float32 weight
        cum = torch.cumsum(w2, 0, dtype=torch.float64)
        tot = torch.clamp_min(cum[-1], 1e-30)
        pick = torch.searchsorted(cum, draws.to(torch.float64) * tot)  # first cum >= u
        pick = torch.where(pick < nK, pick, 0)          # no hit: index 0, as argmax
        drawn = torch.clamp_min(cand.index_select(0, pick), 0)

    src_ids = torch.cat([prev_ids.to(torch.int32), drawn.to(torch.int32)])
    src_mask = torch.cat([prev_mask, torch.ones(s, dtype=torch.bool,
                                                device=prev_mask.device)])
    n_src = n_prev + s

    # every window edge to a source slot, the first match winning (prev preferred);
    # masked slots never match (ids are >= 0, cand is -1 on padding). The stable
    # sort keeps an id's slots in slot order, so the first of its run is its lowest
    # slot (a previous-layer one where there is any) and the run's length counts
    # its slots, all drawn ones where none is previous
    key = torch.where(src_mask, src_ids, -2)
    sorted_key, order = torch.sort(key, stable=True)
    lo = torch.searchsorted(sorted_key, cand)
    hi = torch.searchsorted(sorted_key, cand, right=True)
    hit = hi > lo
    uslot = order.index_select(0, torch.clamp_max(lo, n_src - 1)).to(torch.int32)
    is_prev = hit & (uslot < n_prev)
    mult = torch.where(is_prev, 1.0, (hi - lo).to(torch.float32))

    safe_cand = torch.clamp_min(cand, 0)
    if mode == "fastgcn":
        pcol = lap.pfull.index_select(0, safe_cand)     # [nK]
    else:
        # p_j: the weight of every window edge sharing the edge's column, over tot
        colw = torch.zeros(lap.n_node, dtype=torch.float64, device=w2.device)
        colw.index_add_(0, safe_cand, w2.to(torch.float64))
        pcol = (colw.index_select(0, safe_cand) / tot).to(torch.float32)

    scale = 1.0 / torch.clamp_min(pcol * float(s), 1e-12)
    est = torch.where(is_prev, 1.0, mult * scale)
    w = vals.reshape(-1) * est * hit.to(torch.float32)
    return WeightedBlock(
        dst_ids=prev_ids.to(torch.int32),
        src_ids=src_ids,
        slot=torch.where(hit, uslot, 0).reshape(n_prev, K),
        weight=w.reshape(n_prev, K),
        dst_mask=prev_mask,
        src_mask=src_mask,
        n_dst=n_prev,
        n_src=n_src,
        k=K,
    )


def sample_blocks_device_layerwise(
    lap: DeviceLap,
    seeds: torch.Tensor,          # [b] global ids (padded entries allowed)
    seed_mask: torch.Tensor,      # [b] bool
    layer_sizes: Sequence[int],   # outermost (input side) first
    generator: Optional[torch.Generator] = None,
    draws=None,
    mode: str = "fastgcn",
) -> Tuple[torch.Tensor, torch.Tensor, List[WeightedBlock]]:
    """Layer-wise block sampling on the device, blocks outermost first, every shape a
    static function of ``(len(seeds), layer_sizes)``: from the output layer down,
    each layer's sources become the next layer's destinations.

    ``draws[li]`` are layer ``li``'s uniforms (``draw_layer_uniforms``), innermost
    layer first (the JAX package's ``fold_in(key, li)`` order); where ``draws`` is
    None each layer draws from ``generator``."""
    if mode not in MODES:
        raise ValueError(f"unknown layer-wise mode {mode!r}")
    seeds = seeds.to(torch.int32)
    prev_ids, prev_mask = seeds, seed_mask
    blocks: List[WeightedBlock] = []
    for li, s in enumerate(reversed([int(x) for x in layer_sizes])):
        d = (draw_layer_uniforms(s, mode, generator, seeds.device) if draws is None
             else draws[li])
        blk = _layer(lap, prev_ids, prev_mask, s, d, mode)
        blocks.insert(0, blk)
        prev_ids, prev_mask = blk.src_ids, blk.src_mask
    input_nodes = blocks[0].src_ids if blocks else seeds
    return input_nodes, seeds, blocks


class DeviceLayerWiseSampler:
    """Object-style wrapper with ``DeviceNeighborSampler``'s call shape."""

    def __init__(self, layer_sizes: Sequence[int], mode: str = "fastgcn"):
        if mode not in MODES:
            raise ValueError(f"unknown layer-wise mode {mode!r}")
        self.layer_sizes = [int(s) for s in layer_sizes]
        self.mode = mode

    def sample(self, lap: DeviceLap, seeds, generator=None, seed_mask=None, draws=None):
        seeds = torch.as_tensor(np.asarray(seeds), dtype=torch.int32).to(lap.device)
        if seed_mask is None:
            seed_mask = torch.ones(seeds.shape, dtype=torch.bool, device=lap.device)
        return sample_blocks_device_layerwise(lap, seeds, seed_mask, self.layer_sizes,
                                              generator, draws, self.mode)
