"""Full-batch training. Counterpart of the full-batch half of
``dgll_tpu/train/trainer.py``.

The train state is the model and its optimizer. An optimizer is passed as a factory
that takes the parameters, e.g. ``functools.partial(torch.optim.Adam, lr=1e-2)``,
as ``optax.adam(1e-2)`` is passed in the JAX package. Dropout masks are drawn from
the trainer's ``torch.Generator``, seeded from ``seed`` on the training device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from dgll_tpu_torch.train.metrics import accuracy, masked_nll_loss


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: torch.nn.Module, optimizer: Callable) -> TrainState:
    return TrainState(model=model, optimizer=optimizer(model.parameters()))


def make_full_batch_step(loss_fn=masked_nll_loss):
    """Full-batch train step: state, graph, x, labels, mask, generator -> state, loss.

    The loss comes back as a device tensor, so the step does not wait for the device.
    """

    def step(state: TrainState, g, x, labels, mask, generator):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model(g, x, generator=generator), labels, mask)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step


def make_full_batch_eval():
    @torch.no_grad()
    def evaluate(state: TrainState, g, x):
        state.model.eval()
        return state.model(g, x)

    return evaluate


@dataclass
class EpochStats:
    epoch: int
    loss: float
    seconds: float
    val_metric: Optional[float] = None


@dataclass
class History:
    epochs: List[EpochStats] = field(default_factory=list)
    best_val: float = -np.inf
    best_params: Any = None

    def improved(self, v: float) -> bool:
        if v > self.best_val:
            self.best_val = v
            return True
        return False


class FullBatchTrainer:
    def __init__(self, model: torch.nn.Module, optimizer: Callable,
                 loss_fn=masked_nll_loss, seed: int = 0, device="cpu"):
        self.model = model
        self.optimizer = optimizer
        self.device = torch.device(device)
        self.step = make_full_batch_step(loss_fn)
        self.evaluate = make_full_batch_eval()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def fit(
        self,
        g,
        x,
        labels,
        train_mask,
        val_mask=None,
        epochs: int = 100,
        patience: int = 0,
        log_every: int = 0,
        state: Optional[TrainState] = None,
    ):
        dev = self.device
        g = g.to(dev)
        x, labels, train_mask = x.to(dev), labels.to(dev), train_mask.to(dev)
        val_mask = None if val_mask is None else val_mask.to(dev)
        if state is None:
            state = create_train_state(self.model.to(dev), self.optimizer)
        hist = History()
        bad = 0
        # Wait for the device each epoch only when something on the host reads a
        # value (validation early-stop or logging); otherwise epochs queue back to
        # back and the losses are read at the end.
        sync_each = val_mask is not None or bool(log_every)
        for epoch in range(epochs):
            t0 = time.perf_counter()
            state, loss = self.step(state, g, x, labels, train_mask, self.generator)
            if sync_each:
                loss = float(loss)
            dt = time.perf_counter() - t0
            val = None
            if val_mask is not None:
                val = accuracy(self.evaluate(state, g, x), labels, val_mask)
                if hist.improved(val):
                    hist.best_params = {k: v.detach().clone()
                                        for k, v in state.model.state_dict().items()}
                    bad = 0
                else:
                    bad += 1
            hist.epochs.append(EpochStats(epoch, loss, dt, val))
            if log_every and epoch % log_every == 0:
                print(f"epoch {epoch:4d} loss {loss:.4f} val {val}")
            if patience and bad >= patience:
                break
        if not sync_each:
            for e in hist.epochs:
                e.loss = float(e.loss)
        return state, hist
