"""Carry parameters across from the JAX package.

``skipgram_from_jax`` takes a ``SkipGramModel``'s tables, ``tp_params_from_numpy`` a
tensor-parallel GCN's whole parameters (this rank's slices out). ``params_from_flax``
takes a flax ``GCN``, ``GAT``, ``GraphSAGE``, ``GINNode`` or
``GIN`` parameter tree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX side)
and returns a ``state_dict`` for this package's model of the same name. A flax
``Dense`` kernel is ``[in, out]``; a torch ``Linear`` weight is ``[out, in]``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``GCNConv_i/weight/kernel`` or ``GATConv_i/weight/kernel`` ->
    ``convs.i.linear.weight`` (transposed; for GAT the columns are head-major,
    ``[in, H*F]``, as in both packages); ``GCNConv_i/bias`` -> ``convs.i.bias``;
    ``GATConv_i/attn_src`` and ``attn_dst`` (``[H, F]``) -> ``convs.i.attn_src`` and
    ``convs.i.attn_dst``; ``SAGEConv_i/{neigh,self}/kernel`` and
    ``SAGEConv_i/self/bias`` -> ``convs.i.{neigh,self}.weight`` (transposed) and
    ``convs.i.self.bias``; GraphSAGE's ``out_proj/{kernel,bias}`` ->
    ``out_proj.weight`` (transposed) and ``out_proj.bias``; ``GINConv_i/mlp/{kernel,
    bias}`` and ``GINConv_i/eps`` -> ``convs.i.mlp.{weight,bias}`` (transposed) and
    ``convs.i.eps``; GIN's readout ``Dense_0/{kernel,bias}`` -> ``readout.weight``
    (transposed) and ``readout.bias``."""
    state = {}
    if "Dense_0" in params and not any(k.startswith("GINConv_") for k in params):
        raise ValueError("not a GCN, GAT, GraphSAGE or GIN parameter tree: a readout "
                         "'Dense_0' without GIN layers")
    for name, layer in params.items():
        if name in ("out_proj", "Dense_0"):
            state.update(_dense("readout" if name == "Dense_0" else name, layer))
            continue
        kind, _, idx = name.rpartition("_")
        if kind not in ("GCNConv", "GATConv", "SAGEConv", "GINConv") or not idx.isdigit():
            raise ValueError(f"not a GCN, GAT, GraphSAGE or GIN parameter tree: "
                             f"unexpected entry {name!r}")
        if kind == "SAGEConv":
            for part in ("neigh", "self"):
                state.update(_dense(f"convs.{idx}.{part}", layer[part]))
            continue
        if kind == "GINConv":
            state.update(_dense(f"convs.{idx}.mlp", layer["mlp"]))
            if "eps" in layer:
                state[f"convs.{idx}.eps"] = _tensor(layer["eps"])
            continue
        state[f"convs.{idx}.linear.weight"] = _tensor(layer["weight"]["kernel"]).T.contiguous()
        for key in ("bias", "attn_src", "attn_dst"):
            if key in layer:
                state[f"convs.{idx}.{key}"] = _tensor(layer[key])
    return state


def _dense(prefix: str, dense: Mapping) -> Dict[str, torch.Tensor]:
    """A flax ``Dense``'s ``kernel`` ``[in, out]`` (and ``bias``) as a torch
    ``Linear``'s ``weight`` ``[out, in]`` (and ``bias``)."""
    state = {f"{prefix}.weight": _tensor(dense["kernel"]).T.contiguous()}
    if "bias" in dense:
        state[f"{prefix}.bias"] = _tensor(dense["bias"])
    return state


def skipgram_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """A JAX ``SkipGramModel.params`` (``w_in``, ``w_out``, ``[n_node, dim]``, as numpy)
    -> the ``state_dict`` of the port's ``SkipGramModel`` (the same tables)."""
    return {k: _tensor(params[k]) for k in ("w_in", "w_out")}


def tp_params_from_numpy(params: Mapping, mesh) -> Dict[str, torch.Tensor]:
    """The whole ``w1 [F, H]``, ``w2 [H, C]`` and ``b2 [C]`` of a tensor-parallel GCN
    -> rank ``mesh.rank``'s parts: ``w1``'s columns and ``w2``'s rows of its ``H/D``
    slice, ``b2`` whole (``parallel/tp.py``)."""
    hidden = np.shape(params["w1"])[1]
    if hidden % mesh.size:
        raise ValueError(f"hidden {hidden} must split over {mesh.size} ranks")
    k = hidden // mesh.size
    cols = slice(mesh.rank * k, (mesh.rank + 1) * k)
    return {"w1": _tensor(np.asarray(params["w1"])[:, cols]),
            "w2": _tensor(np.asarray(params["w2"])[cols]),
            "b2": _tensor(params["b2"])}
