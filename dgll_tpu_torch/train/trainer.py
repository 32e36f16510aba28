"""Training loops. Counterpart of ``dgll_tpu/train/trainer.py``:

* ``FullBatchTrainer``: the whole graph's forward and backward as one step an epoch;
* ``MiniBatchTrainer``: a step per batch of sampled blocks from a ``DataLoader``,
  whose producer thread samples ahead while the device runs the steps, and whose
  feature fetch (``fetch_fn``, e.g. an ``HBMFeatureCache``) runs one batch ahead on
  a worker thread.

The train state is the model and its optimizer. An optimizer is passed as a factory
that takes the parameters, e.g. ``functools.partial(torch.optim.Adam, lr=1e-2)``,
as ``optax.adam(1e-2)`` is passed in the JAX package. Dropout masks are drawn from
the trainer's ``torch.Generator``, seeded from ``seed`` on the training device. Both
trainers run on a CUDA device unless the caller asks for the CPU (``device="cpu"``).
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
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


def make_block_step(loss_fn=masked_nll_loss):
    """Minibatch train step over sampled blocks: state, blocks, x, labels, mask,
    generator -> state, loss. ``x`` are the gathered input features ``[n_src_0, d]``;
    ``labels`` and ``mask`` are the padded seed batch's. The loss comes back as a
    device tensor."""

    def step(state: TrainState, blocks, x, labels, mask, generator):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.model(list(blocks), x, generator=generator), labels, mask)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return step


def make_block_eval():
    @torch.no_grad()
    def evaluate(state: TrainState, blocks, x):
        state.model.eval()
        return state.model(list(blocks), x)

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
                 loss_fn=masked_nll_loss, seed: int = 0, device="cuda"):
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


class MiniBatchTrainer:
    def __init__(self, model: torch.nn.Module, optimizer: Callable,
                 loss_fn=masked_nll_loss, seed: int = 0, device="cuda"):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.device = torch.device(device)
        self.step = make_block_step(loss_fn)
        self.evaluate = make_block_eval()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def init_state(self) -> TrainState:
        """The model on the training device and a fresh optimizer. The model holds
        its parameters from its construction, so no first batch is traced, as the
        JAX package's ``init_state(blocks, x)`` does."""
        return create_train_state(self.model.to(self.device), self.optimizer)

    def _on_device(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return None if t is None else torch.as_tensor(t).to(self.device)

    def batch_inputs(self, blocks, features, labels, x=None):
        """A batch's step inputs: its blocks on the device, its input features
        (``x``, or the gather of ``features`` by the first block's source ids), its
        labels and its seed mask."""
        blocks = [b.to(self.device) for b in blocks]
        if x is None:
            x = features.index_select(0, blocks[0].src_ids)
        y = labels.index_select(0, blocks[-1].dst_ids)
        return blocks, x, y, blocks[-1].dst_mask

    def run_epoch(self, state: TrainState, loader, features, labels,
                  fetch_fn: Optional[Callable] = None) -> tuple:
        """One epoch over the loader: ``(state, mean loss, seconds)``.

        ``features``/``labels`` are the full ``[N, d]``/``[N]`` tensors, gathered on
        the device by the blocks' ids. ``fetch_fn(input_nodes) -> [n_src, d]``
        replaces the feature gather (e.g. ``HBMFeatureCache.fetch``; ``features``
        may then be None): it is called with the batch's host ``input_nodes`` (the
        first block's source ids), one batch ahead on a worker thread, so that the
        host gather of batch k+1 overlaps the device step of batch k.

        The loss is summed on the device and read once, at the end of the epoch, so
        that no step waits for the device.
        """
        features, labels = self._on_device(features), self._on_device(labels)
        total, nb = None, 0
        t0 = time.perf_counter()

        def train(blocks, x=None):
            nonlocal state, total, nb
            blocks, x, y, m = self.batch_inputs(blocks, features, labels, x)
            state, loss = self.step(state, blocks, x, y, m, self.generator)
            total = loss if total is None else total + loss
            nb += 1

        if fetch_fn is None:
            for _, _, blocks in loader:
                train(blocks)
        else:
            with ThreadPoolExecutor(1) as ex:
                it = iter(loader)
                cur = next(it, None)
                fut = None if cur is None else ex.submit(fetch_fn, cur[0])
                while cur is not None:
                    blocks = cur[2]
                    x = fut.result()
                    cur = next(it, None)
                    if cur is not None:
                        fut = ex.submit(fetch_fn, cur[0])
                    train(blocks, x)
        total = float(total) if total is not None else 0.0
        return state, total / max(nb, 1), time.perf_counter() - t0

    def evaluate_nodes(self, state: TrainState, loader, features, labels,
                       fetch_fn: Optional[Callable] = None) -> float:
        """Sampled evaluation accuracy over the loader's seed nodes."""
        pred, y = self.predict_nodes(state, loader, features, labels, fetch_fn)
        return float((pred == y).mean()) if len(pred) else 0.0

    def predict_nodes(self, state: TrainState, loader, features, labels,
                      fetch_fn: Optional[Callable] = None):
        """Predicted classes and true labels of every real (unpadded) seed node, as
        1-D numpy arrays."""
        features, labels = self._on_device(features), self._on_device(labels)
        preds, ys = [], []
        for inp, _, blocks in loader:
            x = None if fetch_fn is None else fetch_fn(inp)
            blocks, x, y, m = self.batch_inputs(blocks, features, labels, x)
            pred = self.evaluate(state, blocks, x).argmax(-1)
            preds.append(pred[m].cpu().numpy())
            ys.append(y[m].cpu().numpy())
        if not preds:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(preds), np.concatenate(ys)
