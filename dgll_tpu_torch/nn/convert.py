"""Carry parameters across from the JAX package.

``params_from_flax`` takes a flax ``GCN``, ``GAT`` or ``GraphSAGE`` parameter tree as
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
    ``out_proj.weight`` (transposed) and ``out_proj.bias``."""
    state = {}
    for name, layer in params.items():
        if name == "out_proj":
            state.update(_dense(name, layer))
            continue
        kind, _, idx = name.rpartition("_")
        if kind not in ("GCNConv", "GATConv", "SAGEConv") or not idx.isdigit():
            raise ValueError(f"not a GCN, GAT or GraphSAGE parameter tree: unexpected "
                             f"entry {name!r}")
        if kind == "SAGEConv":
            for part in ("neigh", "self"):
                state.update(_dense(f"convs.{idx}.{part}", layer[part]))
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
