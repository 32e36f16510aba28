"""Tensor-parallel (feature-dimension) sharding of GNN layers: counterpart of
``dgll_tpu/parallel/tp.py``.

SpMM aggregation ``out[i] = sum_e w_e x[src_e]`` is independent for each feature
column, so a rank that holds ``F/D`` columns of x aggregates them alone, with no
communication: kernel K1 (``ops/cuda/segment_matmul.py:spmm_chunked``) on the whole
graph's layout, fed this rank's columns. Matmuls then follow the Megatron MLP
pattern: a column-parallel weight makes feature-sharded activations, a row-parallel
weight contracts the sharded dimension, and one all-reduce sums the ranks' partial
products. A 2-layer GCN needs exactly one collective a forward.

Where the JAX package places a sharded array on the mesh, a rank here holds its part:
``shard_features`` its columns, ``replicate`` the whole array. On a CPU tensor K1's
plain version runs.

The functions take JAX's ``axis`` argument, which names a mesh axis there, so that
their signatures match; it is accepted and ignored, since the ranks here form one
flat group.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from dgll_tpu_torch.ops.chunked import build_chunked_pair
from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_chunked
from dgll_tpu_torch.parallel.launch import rank_device
from dgll_tpu_torch.parallel.mesh import Mesh, all_reduce, replicated


def shard_features(mesh: Mesh, x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """This rank's ``F/D`` columns of ``x [N, F]`` (``F`` a multiple of the mesh's
    size), contiguous."""
    f = x.shape[-1]
    if f % mesh.size:
        raise ValueError(f"{f} features do not split over {mesh.size} ranks")
    k = f // mesh.size
    return x[..., mesh.rank * k:(mesh.rank + 1) * k].contiguous()


replicate = replicated  # what each rank holds of a replicated array: all of it


def _layout(mesh: Mesh, src, dst, weight, n_dst: int, device):
    """K1's layout pair of the whole graph on this rank's device (``cuda``: its card),
    over ``[n_dst, max(n_dst, max(src) + 1)]``; ``weight`` None is unit weights."""
    src = np.asarray(src)
    n_cols = max(n_dst, int(src.max()) + 1 if len(src) else 0)
    c, ct = build_chunked_pair(src, np.asarray(dst), n_dst, n_cols,
                               None if weight is None else np.asarray(weight))
    dev = rank_device("cuda" if device is None else device, mesh.rank)
    return c.to(dev), ct.to(dev)


def make_feature_sharded_spmm(mesh: Mesh, src, dst, weight, n_dst: int,
                              axis: str = "model", device=None) -> Callable:
    """``spmm(x_shard) -> [n_dst, F/D]``: the SpMM of this rank's feature columns over
    the whole graph (edges replicated), with no communication; differentiable.
    ``weight`` None is unit weights; ``device``: the rank's card by default."""
    c, ct = _layout(mesh, src, dst, weight, n_dst, device)
    return lambda x: spmm_chunked(c, ct, x.contiguous())[:n_dst]


class _SumOverRanks(torch.autograd.Function):
    """Forward: the ranks' partial products summed (the one all-reduce). Backward:
    the identity. Every rank computes the same loss from the same summed logits, so
    the gradient of its partial product is the gradient of the logits, on every
    rank, with no collective."""

    @staticmethod
    def forward(ctx, part, mesh):
        out = part.clone(memory_format=torch.contiguous_format)
        all_reduce(mesh, out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def make_tp_gcn_apply(mesh: Mesh, src, dst, weight, n_node: int, axis: str = "model",
                      device=None) -> Callable:
    """The 2-layer tensor-parallel GCN forward,
    ``apply(params, x) = log_softmax(A relu(A X W1) W2 + b2)``, ``[n_node, C]`` on every
    rank.

    ``params`` holds this rank's parts (``init_tp_gcn_params``): ``w1 [F, H/D]``, a
    column slice (activations sharded by column), ``w2 [H/D, C]``, a row slice (the
    partial logits summed over the ranks, the one all-reduce), ``b2 [C]`` whole; both
    SpMMs are K1 on this rank's columns. Differentiable in every parameter: the sum's
    backward is the identity (``_SumOverRanks``), so a rank's gradients are those of
    its slices of the whole loss."""
    c, ct = _layout(mesh, src, dst, weight, n_node, device)

    def apply(params, x):
        h = spmm_chunked(c, ct, (x @ params["w1"]).contiguous(),
                         activation="relu")[:n_node]
        part = spmm_chunked(c, ct, h)[:n_node] @ params["w2"]
        return torch.log_softmax(_SumOverRanks.apply(part, mesh) + params["b2"], dim=-1)

    return apply


def init_tp_gcn_params(mesh: Mesh, f_in: int, hidden: int, n_class: int, seed: int = 0,
                       axis: str = "model", device=None) -> dict:
    """This rank's parts of the 2-layer GCN's parameters, the JAX package's
    ``default_rng(seed)`` draws: ``w1``'s columns and ``w2``'s rows of this rank,
    ``b2`` whole (``nn.convert.tp_params_from_numpy``), on ``device`` (the rank's
    card by default)."""
    from dgll_tpu_torch.nn.convert import tp_params_from_numpy

    if hidden % mesh.size:
        raise ValueError(f"hidden {hidden} must split over {mesh.size} ranks")
    rng = np.random.default_rng(seed)
    w1 = rng.normal(0, np.sqrt(2.0 / f_in), (f_in, hidden)).astype(np.float32)
    w2 = rng.normal(0, np.sqrt(2.0 / hidden), (hidden, n_class)).astype(np.float32)
    b2 = np.zeros((n_class,), np.float32)
    dev = rank_device("cuda" if device is None else device, mesh.rank)
    return {k: v.to(dev) for k, v in
            tp_params_from_numpy({"w1": w1, "w2": w2, "b2": b2}, mesh).items()}
