"""MQ-style pipelined trainer: cache-aware feature fetch and prefetch-overlapped
steps. Counterpart of ``dgll_tpu/train/pipeline.py``, the twin of the reference's
flagship runtime (MQ-GNN, ``GPU Accelerator/buffer_queues.py`` and ``MQGCN.py``, with
the cached trainers of ``FeatureCache/gcn.py:24-110``):

* the ``DataLoader``'s producer thread samples ahead and moves each batch's blocks
  to the device (MQ-GNN's CPU and GPU queues);
* features come through an ``HBMFeatureCache`` where the matrix does not fit the
  device, or a gather from device-resident features where it does;
* the step is queued on the device without waiting for it, so the device's work
  overlaps the host's sampling and the next batch's copies;
* each batch's ``load`` (the feature fetch and the label gather) and ``compute``
  (the step) go to a ``PhaseTimer``, with the cache's miss rate. As in the JAX
  package these are host times under asynchronous launches: ``compute`` is the time
  to queue the step, and a wait for the device lands in whichever phase first needs
  a result from it.

It runs on a CUDA device unless the caller asks for the CPU (``device="cpu"``).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from dgll_tpu_torch.cache import HBMFeatureCache
from dgll_tpu_torch.dataloader import DataLoader
from dgll_tpu_torch.sampling import HostGraph
from dgll_tpu_torch.train.metrics import masked_nll_loss
from dgll_tpu_torch.train.trainer import (
    TrainState,
    create_train_state,
    make_block_eval,
    make_block_step,
)
from dgll_tpu_torch.utils.profiling import PhaseTimer


class PipelinedTrainer:
    """``features`` is a device tensor (or anything ``torch.as_tensor`` takes) or an
    ``HBMFeatureCache``; ``optimizer`` a factory that takes the parameters. Dropout
    masks come from the trainer's generator (``seed``) on ``device``."""

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: Callable,
        g,
        sampler,
        batch_size: int,
        features,
        labels,
        loss_fn=masked_nll_loss,
        prefetch: int = 2,
        seed: int = 0,
        device="cuda",
    ):
        self.model = model
        self.g = g
        self.sampler = sampler
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.host_g = HostGraph.from_graph(g)
        self.cache = features if isinstance(features, HBMFeatureCache) else None
        self.features = None if self.cache else torch.as_tensor(features).to(self.device)
        self.labels = torch.as_tensor(labels).to(self.device)
        self.step = make_block_step(loss_fn)
        self.evaluate = make_block_eval()
        self.optimizer = optimizer
        self.prefetch = prefetch
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.timer = PhaseTimer()
        self.state: Optional[TrainState] = None

    # ---------------------------------------------------------------- helpers
    def _fetch(self, input_nodes, blocks) -> torch.Tensor:
        """The first block's source features: the cache's fetch of the host ids, or a
        gather from the device-resident features."""
        if self.cache is not None:
            return self.cache.fetch(input_nodes)
        return self.features.index_select(0, blocks[0].src_ids)

    def _loader(self, seeds, shuffle=True, seed=0) -> DataLoader:
        return DataLoader(self.host_g, seeds, self.sampler, self.batch_size,
                          shuffle=shuffle, prefetch=self.prefetch, seed=seed,
                          device=self.device)

    def init(self, seeds) -> "PipelinedTrainer":
        """The model on the device and a fresh optimizer. The JAX package traces a
        first batch for its parameters; the port's model holds them already, and the
        batch is sampled and fetched all the same, so that the sampler's draws and
        the cache's counters stay those of the JAX package."""
        inp, _, _ = self.sampler.sample(self.host_g, np.asarray(seeds)[: self.batch_size],
                                        pad_to=self.batch_size)
        if self.cache is not None:
            self.cache.fetch(inp)
        self.state = create_train_state(self.model.to(self.device), self.optimizer)
        return self

    # ------------------------------------------------------------------ train
    def train_epoch(self, train_seeds, epoch: int = 0) -> float:
        """One epoch; returns the last batch's loss, the epoch's one read of the
        device, as the JAX package does."""
        if self.state is None:
            raise RuntimeError("call init() first")
        loss = None
        for inp, _, blocks in self._loader(train_seeds, seed=self.seed + epoch):
            with self.timer.phase("load"):
                x = self._fetch(inp, blocks)
                y = self.labels.index_select(0, blocks[-1].dst_ids)
            with self.timer.phase("compute"):
                self.state, loss = self.step(self.state, blocks, x, y,
                                             blocks[-1].dst_mask, self.generator)
        return float(loss) if loss is not None else 0.0

    def evaluate_nodes(self, seeds) -> float:
        """Sampled accuracy over ``seeds``."""
        hits, count = 0.0, 0.0
        for inp, _, blocks in self._loader(seeds, shuffle=False, seed=1):
            logp = self.evaluate(self.state, blocks, self._fetch(inp, blocks))
            y = self.labels.index_select(0, blocks[-1].dst_ids)
            m = blocks[-1].dst_mask
            hits += float(((logp.argmax(-1) == y) & m).sum())
            count += float(m.sum())
        return hits / max(count, 1.0)

    def fit(self, train_seeds, val_seeds=None, epochs: int = 10, patience: int = 0,
            log=None) -> dict:
        """``epochs`` epochs, stopping after ``patience`` epochs without a better
        validation accuracy; returns ``history`` (each epoch's ``epoch``, ``loss``,
        ``s`` and ``val``), ``best_val``, ``total_s``, ``phases`` (the timer's
        seconds a phase) and, with a cache, ``cache_miss_rate``."""
        best_val, bad = -np.inf, 0
        history = []
        t0 = time.perf_counter()
        for epoch in range(epochs):
            te = time.perf_counter()
            loss = self.train_epoch(train_seeds, epoch)
            dt = time.perf_counter() - te
            val = None
            if val_seeds is not None and len(val_seeds):
                val = self.evaluate_nodes(val_seeds)
                if val > best_val:
                    best_val, bad = val, 0
                else:
                    bad += 1
            history.append({"epoch": epoch, "loss": loss, "s": dt, "val": val})
            if log:
                log.info(f"epoch {epoch} loss {loss:.4f} val {val} ({dt:.2f}s)")
            if patience and bad >= patience:
                break
        out = {
            "history": history,
            "best_val": best_val,
            "total_s": time.perf_counter() - t0,
            "phases": self.timer.summary(),
        }
        if self.cache is not None:
            out["cache_miss_rate"] = self.cache.miss_rate()[0]
        return out


# the reference's name for its flagship runtime
MQTrainer = PipelinedTrainer
