"""Halo-exchange partitioned SpMM: counterpart of ``dgll_tpu/parallel/halo.py``.

Each rank owns a contiguous range of destination rows (``parallel/partition.py``).
The *halo plan*, built once on the host, lists for each (owner q, requester p) pair
the unique rows of q that p's in-edges read, padded to one size ``H`` (a multiple of
``halo_multiple``). A step then moves ``[D, H, F]`` rows in one all-to-all
(``mesh.all_to_all_rows``): volume proportional to the partition's cut, where the
all-gather of ``gp.make_sharded_spmm`` moves the whole feature matrix.

On each rank the send side is a plain row gather (``index_select``, as JAX's
``jnp.take``), whose backward is an ``index_add`` into the gradient of ``x_local``.
The received rows are appended to ``x_local`` as ``ext [rows + D·H, F]`` and the sum
is kernel K1 (``ops/cuda/segment_matmul.py:spmm_chunked``) on a K1 layout of the
rank's edges over ``[rows, rows + D·H]``, built once from the plan's ``src_remap``;
its backward is K1 on the transpose. ``make_halo_spmm_windowed`` sums the rank's
captured local edges with the windowed kernel K2 instead
(``ops/cuda/spmm_windowed.py``), whose backward is K2 (and K1 on what the transpose's
cut leaves) on the transpose of those edges.

The JAX package pads every shard's windowed layout to one chunk count, an odd one
with metadata rounded to 8 rows, and the features to 128 lanes, so that one
``shard_map`` body of static shape serves the mesh; a rank here holds its own layout
at its own size, and the features at their width. On a CPU tensor the kernels' plain
versions run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dgll_tpu_torch.ops.chunked import build_chunked_pair
from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_chunked
from dgll_tpu_torch.ops.cuda.spmm_windowed import spmm_hybrid
from dgll_tpu_torch.ops.windowed import HybridCSR, WindowedCSR, build_hybrid, build_windowed
from dgll_tpu_torch.parallel.launch import rank_device
from dgll_tpu_torch.parallel.mesh import Mesh, all_to_all_rows
from dgll_tpu_torch.parallel.partition import PartitionedGraph


@dataclass
class HaloPlan:
    """The exchange of every rank (host numpy); rank r reads row r of each array."""

    send_ids: np.ndarray   # [D, D, H] int32: send_ids[q, p] = local rows q sends to p
    send_mask: np.ndarray  # [D, D, H] bool
    src_remap: np.ndarray  # [D, e_shard] int32 into [local rows | D*H halo rows]
    halo_size: int = 0


def build_halo_plan(pg: PartitionedGraph, halo_multiple: int = 8) -> HaloPlan:
    """The halo plan of ``pg`` (host numpy, vectorised): per requester p, the unique
    off-shard sources of its edges of nonzero weight, grouped by owner; ``H`` is the
    largest group, at least 1, rounded up to a multiple of ``halo_multiple``."""
    D, rows = pg.n_shard, pg.rows_per_shard
    src = np.asarray(pg.src).astype(np.int64)   # [D, e_shard] global ids
    w = np.asarray(pg.edge_weight)
    n_node = D * rows

    # per requester p: sorted unique remote sources, already grouped by owner
    needs = []
    H = 1
    for p in range(D):
        sp = src[p]
        need = np.unique(sp[(sp // rows != p) & (w[p] != 0)])
        needs.append(need)
        if len(need):
            H = max(H, int(np.bincount(need // rows, minlength=D).max()))
    H = ((H + halo_multiple - 1) // halo_multiple) * halo_multiple

    send_ids = np.zeros((D, D, H), np.int32)     # [owner q, requester p]
    send_mask = np.zeros((D, D, H), bool)
    slot_of = np.zeros(n_node, np.int64)         # per-p id -> halo slot (reused)
    src_remap = np.zeros((D, src.shape[1]), np.int32)
    for p in range(D):
        need = needs[p]
        owner = need // rows
        # rank within the owner's group (need is sorted, so groups are runs)
        starts = np.searchsorted(owner, np.arange(D))
        within = np.arange(len(need), dtype=np.int64) - starts[owner]
        send_ids[owner, p, within] = (need - owner * rows).astype(np.int32)
        send_mask[owner, p, within] = True
        slot_of[need] = owner * H + within
        sp = src[p]
        local = (sp // rows) == p
        src_remap[p] = np.where(local, sp - p * rows, rows + slot_of[sp])
        slot_of[need] = 0  # reset the touched entries for the next requester
    return HaloPlan(send_ids, send_mask, src_remap, H)


def halo_volume_bytes(pg: PartitionedGraph, plan: HaloPlan, feat_dim: int,
                      itemsize: int = 4) -> int:
    """The all-to-all's bytes a step, over the whole mesh."""
    return pg.n_shard * pg.n_shard * plan.halo_size * feat_dim * itemsize


def allgather_volume_bytes(pg: PartitionedGraph, feat_dim: int, itemsize: int = 4) -> int:
    """The all-gather's bytes a step, over the whole mesh."""
    return pg.n_shard * (pg.n_shard - 1) * pg.rows_per_shard * feat_dim * itemsize


def _source(mesh: Mesh, shard_or_pg, device) -> Tuple[PartitionedGraph, torch.device]:
    """The partitioned graph and this rank's device: a ``GraphShard``'s own, or
    ``device`` (``cuda``: the rank's card) for a ``PartitionedGraph``."""
    from dgll_tpu_torch.parallel.gp import GraphShard

    if isinstance(shard_or_pg, GraphShard):
        return shard_or_pg.pg, shard_or_pg.device
    return shard_or_pg, rank_device("cuda" if device is None else device, mesh.rank)


def halo_layout(pg: PartitionedGraph, plan: HaloPlan, rank: int,
                weight: Optional[np.ndarray] = None):
    """K1's layout pair (host) of rank ``rank``'s edges over ``[rows, rows + D·H]``:
    its destination rows, and as sources its own rows then the halo rows, through the
    plan's ``src_remap``; ``weight`` (its row of edge weights, default ``pg``'s) leaves
    its slots of weight 0 out."""
    D, rows = pg.n_shard, pg.rows_per_shard
    weight = pg.edge_weight[rank] if weight is None else weight
    keep = weight != 0
    return build_chunked_pair(plan.src_remap[rank][keep], pg.dst_local[rank][keep], rows,
                              rows + D * plan.halo_size, weight[keep])


def _halo_sum(mesh: Mesh, pg: PartitionedGraph, plan: HaloPlan, weight: np.ndarray,
              device) -> Callable:
    """``x_local [rows, F] -> [rows, F]``: the sum over this rank's edges of weight
    ``weight`` through the exchange and K1 on ``halo_layout``."""
    if pg.n_shard != mesh.size:
        raise ValueError(f"{pg.n_shard} shards over a mesh of {mesh.size} ranks")
    D, rows, H, r = pg.n_shard, pg.rows_per_shard, plan.halo_size, mesh.rank
    c, ct = halo_layout(pg, plan, r, weight)
    c, ct = c.to(device), ct.to(device)
    send_ids = torch.from_numpy(plan.send_ids[r].reshape(-1).astype(np.int64)).to(device)
    send_mask = torch.from_numpy(plan.send_mask[r].reshape(-1, 1)).to(device)

    def spmm(x_local: torch.Tensor) -> torch.Tensor:
        f = x_local.shape[-1]
        # the rows this rank owes each peer: a plain gather (its backward an index_add)
        out_rows = x_local.index_select(0, send_ids) * send_mask.to(x_local.dtype)
        halo = all_to_all_rows(mesh, out_rows.view(D, H, f))
        ext = torch.cat([x_local, halo.reshape(D * H, f)])
        return spmm_chunked(c, ct, ext)[:rows]

    return spmm


def make_halo_spmm(mesh: Mesh, shard_or_pg, plan: HaloPlan, device=None) -> Callable:
    """``spmm(x_local) -> [rows, F]``: ``out[i] = sum_e w_e x[src_e]`` over the in-edges
    of this rank's destination rows, ``x_local`` being its ``[rows, F]`` rows of x,
    with the halo rows exchanged in one all-to-all; differentiable in ``x_local``.
    ``shard_or_pg``: a ``GraphShard`` (its device) or a ``PartitionedGraph`` (on
    ``device``, the rank's card by default)."""
    pg, dev = _source(mesh, shard_or_pg, device)
    return _halo_sum(mesh, pg, plan, pg.edge_weight[mesh.rank], dev)


def make_partitioned_spmm(mesh: Mesh, pg: PartitionedGraph, feat_dim: int,
                          strategy: str = "auto", device=None):
    """``(spmm, "halo" | "allgather")``: the halo exchange where its all-to-all moves
    fewer bytes than the all-gather (clustered graphs with a small cut), else the
    all-gather (``gp.make_sharded_spmm``); ``strategy`` forces either. ``device``:
    where the shard lives, the rank's card by default."""
    from dgll_tpu_torch.parallel.gp import make_sharded_spmm, shard_partitioned_graph

    if strategy not in ("auto", "halo", "allgather"):
        raise ValueError(f"unknown strategy {strategy!r}")
    device = "cuda" if device is None else device
    if strategy != "allgather":
        plan = build_halo_plan(pg)
        if strategy == "halo" or (halo_volume_bytes(pg, plan, feat_dim)
                                  < allgather_volume_bytes(pg, feat_dim)):
            return make_halo_spmm(mesh, pg, plan, device), "halo"
    return make_sharded_spmm(mesh, shard_partitioned_graph(pg, mesh, device)), "allgather"


# --------------------------------------------------------------- windowed local
@dataclass
class ShardWindowed:
    """Rank ``rank``'s windowed layout of its captured local edges (source and
    destination both owned, weight nonzero), over ``[rows, rows]``, and the hybrid
    layout of their transpose (the backward's); both None where the rank's cut
    captures no edge. ``remaining_weight`` is every shard's edge weights with the
    captured edges zeroed (the halo path's K1 sums the rest); ``windowed_fraction``
    the captured edges over the nonzero edges of all shards."""

    win: Optional[WindowedCSR]
    win_t: Optional[HybridCSR]
    remaining_weight: np.ndarray  # [D, e_shard] float32
    rank: int
    windowed_fraction: float = 0.0


def build_shard_windowed(pg: PartitionedGraph, rank: Optional[int] = None) -> ShardWindowed:
    """Host side: each shard's local edges cut by ``ops/windowed.build_windowed`` (the
    JAX package's cut) over ``[rows, rows]``; the layout kept for ``rank`` (default:
    this process's rank in the default group, 0 outside one). Every shard is cut, so
    that ``remaining_weight`` and ``windowed_fraction`` cover the mesh."""
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    D, rows = pg.n_shard, pg.rows_per_shard
    src = np.asarray(pg.src).astype(np.int64)
    dstl = np.asarray(pg.dst_local).astype(np.int64)
    w = np.asarray(pg.edge_weight)
    rem_w = w.copy()
    captured = total = 0
    win = win_t = None
    for p in range(D):
        idx = np.nonzero(((src[p] // rows) == p) & (w[p] != 0))[0]
        s, d, wp = src[p][idx] - p * rows, dstl[p][idx], w[p][idx]
        lay, resid = build_windowed(s, d, rows, rows, wp)
        keep = np.ones(len(idx), bool)
        if resid is not None:
            keep[resid] = False
        rem_w[p][idx[keep]] = 0.0       # the captured edges leave the K1 path
        captured += int(keep.sum())
        total += int((w[p] != 0).sum())
        if p == rank and keep.any():
            win = lay
            win_t = build_hybrid(d[keep], s[keep], rows, rows, wp[keep])
    return ShardWindowed(win, win_t, rem_w, rank, captured / max(total, 1))


def make_halo_spmm_windowed(mesh: Mesh, shard_or_pg, plan: HaloPlan, sw: ShardWindowed,
                            device=None) -> Callable:
    """The halo SpMM whose captured local edges go through the windowed kernel K2 on
    the rank's own rows, the rest (remote edges and the cut's residual) through the
    exchange and K1 (``make_halo_spmm`` with ``sw.remaining_weight``); differentiable
    in ``x_local``. The all-to-all is the same one."""
    pg, dev = _source(mesh, shard_or_pg, device)
    if sw.rank != mesh.rank:
        raise ValueError(f"the windowed layout of rank {sw.rank} on rank {mesh.rank}")
    rest = _halo_sum(mesh, pg, plan, sw.remaining_weight[mesh.rank], dev)
    if sw.win is None:
        return rest
    # K2 over the captured edges; its backward runs on the transpose's hybrid cut
    h, ht, rows = HybridCSR(sw.win.to(dev), None), sw.win_t.to(dev), pg.rows_per_shard

    def spmm(x_local: torch.Tensor) -> torch.Tensor:
        return spmm_hybrid(h, ht, x_local.contiguous())[:rows] + rest(x_local)

    return spmm
