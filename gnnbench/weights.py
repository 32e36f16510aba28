"""A model's initial weights, made on the device from the seed in one draw.

Every leaf that ``specs`` does not set to zeros takes its slice of one
``torch.randn`` on a generator of the device, scaled to the leaf's rule:
``fan_in``, standard deviation ``1 / sqrt(in)`` (a ``[out, in]`` weight); ``glorot``,
``sqrt(2 / (rows + columns))``. The program and the reference get the same tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch


def make(specs: List[tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    drawn = [s for s in specs if s[2] != "zeros"]
    flat = torch.randn(sum(math.prod(shape) for _, shape, _ in drawn), generator=gen,
                       device=device)
    out, at = {}, 0
    for name, shape, init in specs:
        if init == "zeros":
            out[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        if init == "fan_in":
            std = 1.0 / math.sqrt(shape[-1])
        elif init == "glorot":
            std = math.sqrt(2.0 / (shape[0] + shape[-1]))
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
        out[name] = flat[at: at + n].view(shape) * std
        at += n
    return out


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s parameters, which must be exactly these
    leaves with these shapes."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the model's parameters {sorted(params)} are not the "
                         f"reference's {sorted(weights)}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: the model has {tuple(p.shape)}, the reference "
                                 f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])
