"""Carry parameters across from the JAX package.

``params_from_flax`` takes a flax ``GCN`` parameter tree as nested dicts of numpy
arrays (``jax.tree.map(np.asarray, params)`` on the JAX side) and returns a
``state_dict`` for this package's ``GCN``. A flax ``Dense`` kernel is ``[in, out]``;
a torch ``Linear`` weight is ``[out, in]``.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``GCNConv_i/weight/kernel`` -> ``convs.i.linear.weight`` (transposed) and
    ``GCNConv_i/bias`` -> ``convs.i.bias``."""
    state = {}
    for name, layer in params.items():
        kind, _, idx = name.rpartition("_")
        if kind != "GCNConv" or not idx.isdigit():
            raise ValueError(f"not a GCN parameter tree: unexpected entry {name!r}")
        kernel = np.asarray(layer["weight"]["kernel"], np.float32)
        state[f"convs.{idx}.linear.weight"] = torch.from_numpy(kernel.T.copy())
        if "bias" in layer:
            state[f"convs.{idx}.bias"] = torch.from_numpy(
                np.array(layer["bias"], np.float32))
    return state
