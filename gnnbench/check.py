"""The comparison that decides ``correct``.

A training cell's set-up drives the step the window will run through its first three
steps and keeps a ``Snapshot``: each step's loss, the first gradient as the optimizer
got it (Adam's first moment after one step over ``1 - beta1``), and the parameters
before each step and after the third (before the fourth overwrites them). The
reference then follows the program step by step from the program's own state: step
``k`` starts from the program's parameters before it (step 1 from the benchmark's
weights) and the same batch, draws and dropout masks, computes the loss and the
gradient, and moves the parameters by its own Adam, whose moments it carries along
that path. ``readings`` compares:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: over the leaves, the largest gap between the program's and the
  reference's norm of the first gradient, over the larger of the reference's norm of
  that leaf and of the median leaf;
* ``median_change_gap``: for each step, the median over the leaves of the same gap of
  the norm of each leaf's move in that step, over the leaves whose reference gradient
  is at least a thousandth of the median leaf's (a leaf whose gradient is nought to
  rounding, such as an attention vector a softmax cancels, moves under Adam by
  round-off alone); the largest over the steps.

Why step by step and the median: chained, the reference drifts from the program by
rounding that Adam and the models' kinks amplify. On the chip one seed in twenty of
``gat8x8.products`` read a step-3 loss 1.6e-6 apart and a median change 1.8e-5 apart
while each single step agreed to 1e-6; and an element whose gradient lies near
Adam's epsilon moves the worst leaf's change by 3e-7 to 1.2e-5 from seed to seed
(``PERF.md``). Each number is held to its limit in ``workloads/<cell>.json``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

NAMES = ("loss_gap", "grad_gap", "median_change_gap")
STILL = 1e-3  # a leaf whose reference gradient is below this share of the median's


@dataclass
class Snapshot:
    """Three steps: each step's loss, the first gradient, and each step's move of the
    parameters (``moves[k]``, leaf by leaf). A program's snapshot also keeps the
    parameters before each step (``starts``), which the reference starts from."""

    losses: List[float]
    grad: Dict[str, torch.Tensor]
    moves: List[Dict[str, torch.Tensor]]
    starts: Optional[List[Dict[str, torch.Tensor]]] = None


def trajectory(losses, grad, params: List[Dict[str, torch.Tensor]]) -> Snapshot:
    """A program's snapshot from its parameters before step 1 and after each step."""
    moves = [{k: b[k] - a[k] for k in a} for a, b in zip(params, params[1:])]
    return Snapshot(list(losses), grad, moves, params[:-1])


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def _median(values) -> float:
    s = sorted(values)
    return s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1] + s[len(s) // 2])


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    med = _median([ref[k] for k in keys])
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def leaf_gaps(prog: Snapshot, ref: Snapshot) -> dict:
    """Each leaf's gap of the first gradient and of its move (the largest over the
    steps), and each step's median leaf gap of the move."""
    gr = _norms(ref.grad)
    keys = sorted(gr)
    med = _median([gr[k] for k in keys])
    moving = [k for k in keys if gr[k] >= STILL * med]
    steps = [_gaps(_norms(p), _norms(r), moving) for p, r in zip(prog.moves, ref.moves)]
    return {"grad_gap": _gaps(_norms(prog.grad), gr, keys),
            "change_gap": {k: max(s[k] for s in steps) for k in moving},
            "median_by_step": [_median(s.values()) for s in steps]}


def readings(prog: Snapshot, ref: Snapshot) -> Dict[str, float]:
    losses = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog.losses, ref.losses))
    leaves = leaf_gaps(prog, ref)
    return {"loss_gap": losses, "grad_gap": max(leaves["grad_gap"].values()),
            "median_change_gap": max(leaves["median_by_step"])}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """``(correct, checks)``: every number at or under its limit (a number that is
    not finite fails), and ``{name: {"value", "limit"}}``."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NAMES}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
