"""Runs ``gnnbench.run.main`` with the port's timed path broken underneath by one
fault (the first argument), then the harness's arguments:

* ``unchanged``: every optimizer step returns the state unchanged;
* ``half_batch``: the port's loss leaves out the second half of each batch (of the
  train nodes, in full batch), the mean taken over the rest.
"""
import sys

import torch

import dgll_tpu_torch.train as train
from dgll_tpu_torch.train.metrics import masked_nll_loss


def half_loss(log_probs, labels, mask=None):
    keep = torch.arange(labels.shape[0], device=labels.device) < labels.shape[0] // 2
    if mask is not None and mask.sum() < labels.shape[0]:  # full batch: half the train nodes
        keep = mask.cumsum(0) <= mask.sum() // 2
    return masked_nll_loss(log_probs, labels, keep if mask is None else mask & keep)


def main() -> int:
    fault, args = sys.argv[1], sys.argv[2:]
    if fault == "unchanged":
        for cls in (torch.optim.Adam, torch.optim.AdamW):
            cls.step = lambda self, closure=None: None
    elif fault == "half_batch":
        runner = train.DeviceEpochRunner

        class HalfRunner(runner):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.loss_fn = half_loss

        train.DeviceEpochRunner = HalfRunner
        full_step = train.make_full_batch_step
        train.make_full_batch_step = lambda loss_fn=None: full_step(half_loss)
    else:
        raise SystemExit(f"unknown fault {fault!r}")
    from gnnbench import run

    return run.main(args)


if __name__ == "__main__":
    sys.exit(main())
