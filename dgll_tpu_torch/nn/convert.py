"""Carry parameters across from the JAX package.

``params_from_flax`` takes a flax ``GCN`` or ``GAT`` parameter tree as nested dicts
of numpy arrays (``jax.tree.map(np.asarray, params)`` on the JAX side) and returns a
``state_dict`` for this package's model of the same name. A flax ``Dense`` kernel is
``[in, out]``; a torch ``Linear`` weight is ``[out, in]``.
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
    ``convs.i.attn_dst``."""
    state = {}
    for name, layer in params.items():
        kind, _, idx = name.rpartition("_")
        if kind not in ("GCNConv", "GATConv") or not idx.isdigit():
            raise ValueError(f"not a GCN or GAT parameter tree: unexpected entry {name!r}")
        state[f"convs.{idx}.linear.weight"] = _tensor(layer["weight"]["kernel"]).T.contiguous()
        for key in ("bias", "attn_src", "attn_dst"):
            if key in layer:
                state[f"convs.{idx}.{key}"] = _tensor(layer[key])
    return state
