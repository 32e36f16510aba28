"""Checkpoints of model parameters, one file a step.

Counterpart of ``dgll_tpu/train/checkpoint.py:CheckpointManager``, which wraps
orbax. Here a checkpoint is ``step_<n>.pt`` in the directory, written with
``torch.save`` (to a temporary name, then renamed) and read with
``torch.load(weights_only=True)``: a dict of tensors, typically a model's
``state_dict()``. The newest ``max_to_keep`` steps are kept. The files are not
orbax checkpoints and orbax's are not read; ``nn/convert.py`` carries JAX
parameters across instead.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """Save and restore parameter dicts by step in ``directory`` (created if
    missing), keeping the newest ``max_to_keep``."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be at least 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def steps(self) -> List[int]:
        """The saved steps, ascending."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, state: Mapping[str, torch.Tensor],
             wait: bool = False) -> None:
        """Write ``state`` (a dict of tensors) as step ``step``, then delete all but
        the newest ``max_to_keep`` steps. The write is synchronous, so ``wait`` (the
        JAX manager's flag for its asynchronous save) changes nothing."""
        cpu = {k: v.detach().cpu() for k, v in state.items()}
        tmp = self._path(step) + ".tmp"
        torch.save(cpu, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: Mapping[str, torch.Tensor],
                step: Optional[int] = None) -> Optional[Dict[str, torch.Tensor]]:
        """Step ``step`` (default: the latest) as a dict with ``template``'s keys,
        each tensor of the template's shape, on its device and in its type; None
        where no step is saved. A key or shape that differs raises."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        saved = torch.load(self._path(step), map_location="cpu", weights_only=True)
        if set(saved) != set(template):
            raise ValueError(f"checkpoint step {step} holds {sorted(saved)}, the "
                             f"template {sorted(template)}")
        out = {}
        for k, t in template.items():
            if tuple(saved[k].shape) != tuple(t.shape):
                raise ValueError(f"checkpoint step {step}: {k} is "
                                 f"{tuple(saved[k].shape)}, need {tuple(t.shape)}")
            out[k] = saved[k].to(device=t.device, dtype=t.dtype)
        return out

    def close(self) -> None:
        """Nothing to flush (the saves are synchronous); kept for the JAX API."""
