"""Graph-partition-parallel full-graph training: counterpart of
``dgll_tpu/parallel/gp.py``.

Each rank owns one shard of a ``PartitionedGraph``: a contiguous range of ``rows``
destination nodes, their in-edges (global source ids) and their node arrays. The
shard's SpMM is kernel K1 (``ops/cuda/segment_matmul.py:spmm_chunked``) on a
rectangular layout of A, ``[rows, n_node]``, with its transpose ``[n_node, rows]``
for the backward: a forward all-gathers every rank's ``x`` rows and runs K1; the
backward runs K1 on A^T, which gives a ``[n_node, F]`` gradient, and sums it over the
ranks, each keeping its own rows. The JAX package's padded edge slots have weight 0
and do not enter the layout. On a CPU tensor K1's plain version runs.

The loss is the mean over the train nodes of all shards, as GSPMD computes it over
the global arrays in the JAX package: each rank's masked NLL sum over the global
count of train nodes (all-reduced once), the parameter gradients then summed over
the ranks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.distributed as dist

from dgll_tpu_torch.ops.chunked import ChunkedCSR, build_chunked_pair
from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_chunked
from dgll_tpu_torch.parallel.dp import flat_grads, set_grads
from dgll_tpu_torch.parallel.launch import rank_device
from dgll_tpu_torch.parallel.mesh import Mesh, all_gather_rows, all_reduce
from dgll_tpu_torch.parallel.partition import PartitionedGraph
from dgll_tpu_torch.train.trainer import TrainState


@dataclass
class GraphShard:
    """Rank ``rank``'s shard of a ``PartitionedGraph``, on its device: the K1 layout
    pair of its edges (``chunked``: ``[rows, n_node]``; ``chunked_t``: its transpose),
    its rows of the node arrays (None where the partitioned graph has none) and the
    whole partitioned graph on the host (``pg``), from which the halo exchange builds
    its own layouts."""

    chunked: ChunkedCSR
    chunked_t: ChunkedCSR
    rank: int
    n_shard: int
    rows_per_shard: int
    node_feat: Optional[torch.Tensor] = None
    labels: Optional[torch.Tensor] = None
    train_mask: Optional[torch.Tensor] = None
    val_mask: Optional[torch.Tensor] = None
    test_mask: Optional[torch.Tensor] = None
    pg: Optional[PartitionedGraph] = None

    @property
    def n_node(self) -> int:
        return self.n_shard * self.rows_per_shard

    @property
    def device(self) -> torch.device:
        return self.chunked.indptr.device


def shard_partitioned_graph(pg: PartitionedGraph, mesh: Mesh, device="cuda") -> GraphShard:
    """This rank's shard of ``pg`` on ``device`` (``cuda``: the rank's card,
    ``launch.rank_device``, which raises where there is none; ``"cpu"`` where asked):
    its edge slab as K1's layout pair (slots of weight 0, the padding, left out) and
    its rows of the node arrays."""
    if pg.n_shard != mesh.size:
        raise ValueError(f"{pg.n_shard} shards over a mesh of {mesh.size} ranks")
    r, rows = mesh.rank, pg.rows_per_shard
    device = rank_device(device, r)
    keep = pg.edge_weight[r] != 0
    c, ct = build_chunked_pair(pg.src[r][keep], pg.dst_local[r][keep], rows, pg.n_node,
                               pg.edge_weight[r][keep])

    def rows_of(x):
        return None if x is None else torch.from_numpy(x[r * rows:(r + 1) * rows]).to(device)

    return GraphShard(c.to(device), ct.to(device), r, pg.n_shard, rows,
                      rows_of(pg.node_feat), rows_of(pg.labels), rows_of(pg.train_mask),
                      rows_of(pg.val_mask), rows_of(pg.test_mask), pg)


class _AllGatherRows(torch.autograd.Function):
    """Forward: every rank's rows stacked in rank order. Backward: the gradient of
    the stacked rows summed over the ranks, this rank's rows kept (a reduce-scatter
    over NCCL; gloo has none, so an all-reduce and a slice)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return all_gather_rows(mesh, x)

    @staticmethod
    def backward(ctx, g):
        mesh, n = ctx.mesh, ctx.n
        if mesh.size == 1:
            return g, None
        if mesh.backend == "nccl":
            out = torch.empty((n, *g.shape[1:]), dtype=g.dtype, device=g.device)
            dist.reduce_scatter_tensor(out, g.contiguous(), group=mesh.group)
            return out, None
        g = g.clone(memory_format=torch.contiguous_format)
        all_reduce(mesh, g)
        return g[mesh.rank * n:(mesh.rank + 1) * n], None


def make_sharded_spmm(mesh: Mesh, shard: GraphShard) -> Callable:
    """``spmm(x_local) -> [rows, F]``: out[i] = sum_e w_e x[src_e] over the in-edges
    of this rank's destination rows, ``x_local`` being this rank's ``[rows, F]`` rows
    of x; differentiable in ``x_local`` (K1 on A^T, summed over the ranks)."""
    rows = shard.rows_per_shard

    def spmm(x_local: torch.Tensor) -> torch.Tensor:
        x_full = _AllGatherRows.apply(x_local, mesh)
        return spmm_chunked(shard.chunked, shard.chunked_t, x_full)[:rows]

    return spmm


def make_gp_gcn_train_step(mesh: Mesh, shard: GraphShard, model_apply: Callable,
                           spmm: Optional[Callable] = None):
    """A training step of a model over the partitioned graph:
    ``step(state, x, labels, mask, generator=None) -> (state, loss)``.

    ``model_apply(model, spmm, x, generator) -> log-probs [rows, C]`` builds the
    network on this rank's rows from the sharded SpMM: ``spmm``, or the all-gather's
    (``make_sharded_spmm``) where None. The loss is the masked NLL mean over the
    train nodes of all shards; the parameter gradients and the loss are summed over
    the ranks (one all-reduce) before the optimizer step, which every rank takes
    alike.
    """
    spmm = make_sharded_spmm(mesh, shard) if spmm is None else spmm
    counted: list = []  # (mask, the global number of its nodes): all-reduced once

    def global_count(mask: torch.Tensor) -> torch.Tensor:
        if not counted or counted[0][0] is not mask:
            n = mask.to(torch.float32).sum().reshape(1)
            all_reduce(mesh, n)
            counted[:] = [(mask, n.clamp_min(1.0))]
        return counted[0][1]

    def step(state: TrainState, x, labels, mask, generator=None):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logp = model_apply(state.model, spmm, x, generator)
        nll = -logp.gather(-1, labels[:, None].long())[:, 0]
        loss = (nll * mask.to(nll.dtype)).sum() / global_count(mask)[0]
        loss.backward()
        flat = flat_grads(state, loss)
        all_reduce(mesh, flat)
        set_grads(state, flat)
        state.optimizer.step()
        state.step += 1
        return state, flat[-1]

    return step
