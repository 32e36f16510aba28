"""Data-parallel minibatch training over the ranks: counterpart of
``dgll_tpu/parallel/dp.py``.

The JAX package runs one jitted step over the mesh: the global batch sharded on the
``data`` axis, the gradients ``pmean``-ed inside ``shard_map``. Here each rank runs
its sub-batch's forward and backward, then one all-reduce of a flat buffer (every
gradient and the loss) divided by the mesh's size, then the same optimizer step as
every other rank, so that the ranks' parameters stay bitwise equal.

``ShardedDataLoader`` samples the ``n_shard`` sub-batches of a step in turn from one
sampler, as the JAX controller does; a rank's loader (``rank=r``) samples them all
and keeps sub-batch ``r``, so its blocks equal the JAX package's bit for bit, at the
cost of ``n_shard`` times the host sampling on every rank.

``make_async_dp_block_step`` is the one-step-stale step (``--async_dp``): a step
applies the previous step's averaged gradients first, then computes its own, whose
all-reduce (``async_op=True``) runs while the next step's forward and backward do;
its ``wait()`` comes at the start of the next step. That is what XLA's scheduler does
with the JAX step's collective.
"""
from __future__ import annotations

from dataclasses import fields, replace
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from dgll_tpu_torch.parallel.mesh import Mesh, all_reduce
from dgll_tpu_torch.train.metrics import masked_nll_loss
from dgll_tpu_torch.train.trainer import TrainState


def stack_block_lists(block_lists: Sequence[List]) -> List:
    """Per-device block lists (equal shapes) stacked on a new leading device axis,
    field by field."""
    out = []
    for i in range(len(block_lists[0])):
        layer = [bl[i] for bl in block_lists]
        out.append(replace(layer[0], **{
            f.name: torch.stack([getattr(b, f.name) for b in layer])
            for f in fields(layer[0]) if isinstance(getattr(layer[0], f.name), torch.Tensor)}))
    return out


class ShardedDataLoader:
    """Samples ``n_shard`` per-device sub-batches a step, in turn from one sampler.

    Without ``rank`` it yields ``(outs [n_shard, b], stacked blocks)``, as the JAX
    package's; with ``rank=r`` it samples every sub-batch all the same and yields
    ``(outs[r], blocks of sub-batch r)``: the rank's share of the step."""

    def __init__(self, host_g, seeds, sampler, per_device_batch: int, n_shard: int,
                 shuffle: bool = True, seed: int = 0, rank: Optional[int] = None):
        self.host_g = host_g
        self.seeds = np.asarray(seeds, np.int64)
        self.sampler = sampler
        self.b = int(per_device_batch)
        self.n_shard = int(n_shard)
        self.shuffle = shuffle
        self.rank = rank
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.seeds) // (self.b * self.n_shard)

    def __iter__(self):
        order = (self._rng.permutation(len(self.seeds)) if self.shuffle
                 else np.arange(len(self.seeds)))
        seeds = self.seeds[order]
        span = self.b * self.n_shard
        for i in range(len(self)):
            chunk = seeds[i * span:(i + 1) * span]
            lists, outs = [], []
            for d in range(self.n_shard):
                sub = chunk[d * self.b:(d + 1) * self.b]
                _, out, blocks = self.sampler.sample(self.host_g, sub, pad_to=self.b)
                lists.append(blocks)
                outs.append(out)
            if self.rank is None:
                yield np.stack(outs), stack_block_lists(lists)
            else:
                yield outs[self.rank], lists[self.rank]


def _params(state: TrainState) -> List[torch.Tensor]:
    return [p for p in state.model.parameters() if p.requires_grad]


def flat_grads(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    """Every parameter's gradient (zeros where there is none) and the loss, in one
    float32 buffer: what one all-reduce carries."""
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                      .reshape(-1).float() for p in _params(state)]
                     + [loss.detach().float().reshape(1)])


def set_grads(state: TrainState, flat: torch.Tensor) -> None:
    """Each parameter's gradient as its slice of ``flat`` (the loss's slot last)."""
    off = 0
    for p in _params(state):
        n = p.numel()
        p.grad = flat[off:off + n].view_as(p).to(p.dtype)
        off += n


def local_backward(state: TrainState, blocks, x, labels, mask, generator,
                   loss_fn=masked_nll_loss) -> torch.Tensor:
    """This rank's forward, loss and backward, the gradients set anew."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(state.model(list(blocks), x, generator=generator), labels, mask)
    loss.backward()
    return loss


def make_dp_block_step(mesh: Mesh, loss_fn: Callable = masked_nll_loss):
    """The synchronous DP step: ``step(state, blocks, x, labels, mask, generator=None)
    -> (state, loss)`` on this rank's sub-batch; the gradients and the loss are
    averaged over the ranks (one all-reduce) before the optimizer step, and the loss
    comes back as a device scalar, the mean of the ranks' losses."""

    def step(state: TrainState, blocks, x, labels, mask, generator=None):
        loss = local_backward(state, blocks, x, labels, mask, generator, loss_fn)
        flat = flat_grads(state, loss)
        all_reduce(mesh, flat)
        flat /= mesh.size
        set_grads(state, flat)
        state.optimizer.step()
        state.step += 1
        return state, flat[-1]

    return step


class PendingGrads:
    """A step's gradients and loss (one flat buffer) whose all-reduce over the ranks
    may still be running; ``mean()`` waits for it once and divides by the mesh's
    size."""

    def __init__(self, flat: torch.Tensor, work, n: int):
        self.flat, self.work, self.n = flat, work, n
        self._mean: Optional[torch.Tensor] = None

    def mean(self) -> torch.Tensor:
        if self._mean is None:
            if self.work is not None:
                self.work.wait()
            self._mean = self.flat / self.n
        return self._mean

    @property
    def loss(self) -> torch.Tensor:
        """The mean of the ranks' losses of the step that made these gradients."""
        return self.mean()[-1]


def apply_grads(state: TrainState, pending: PendingGrads) -> TrainState:
    """One optimizer step on ``pending``'s averaged gradients (waiting for their
    all-reduce): the async step's first half, and its final flush."""
    set_grads(state, pending.mean())
    state.optimizer.step()
    return state


def make_async_dp_block_step(mesh: Mesh, loss_fn: Callable = masked_nll_loss):
    """The one-step-stale DP step: ``(step, init_grads)``.

    ``step(state, prev, blocks, x, labels, mask, generator=None) -> (state, pending)``
    applies ``prev`` (a ``PendingGrads``; ``init_grads(state)``'s zeros at the first
    step), then runs this sub-batch's forward and backward at the updated parameters
    and starts their all-reduce; ``pending.loss`` is the step's mean loss. After the
    last batch, ``apply_grads(state, pending)`` flushes the last gradients.
    """

    def init_grads(state: TrainState) -> PendingGrads:
        n = sum(p.numel() for p in _params(state))
        dev = next(state.model.parameters()).device
        return PendingGrads(torch.zeros(n + 1, device=dev), None, 1)

    def step(state: TrainState, prev: PendingGrads, blocks, x, labels, mask,
             generator=None):
        # the stale gradients first: their all-reduce ran during this step's inputs
        apply_grads(state, prev)
        loss = local_backward(state, blocks, x, labels, mask, generator, loss_fn)
        flat = flat_grads(state, loss)
        state.step += 1
        return state, PendingGrads(flat, all_reduce(mesh, flat, async_op=True), mesh.size)

    return step, init_grads
