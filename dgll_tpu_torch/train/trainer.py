"""Training loops. Counterpart of ``dgll_tpu/train/trainer.py``:

* ``FullBatchTrainer``: the whole graph's forward and backward as one step an epoch;
* ``MiniBatchTrainer``: a step per batch of sampled blocks from a ``DataLoader``,
  whose producer thread samples ahead while the device runs the steps, and whose
  feature fetch (``fetch_fn``, e.g. an ``HBMFeatureCache``) runs one batch ahead on
  a worker thread; or, over a ``packed=True`` loader (``run_epoch_packed``), a step
  per batch's two frontier-growth buffers ``(ids, mask)``, from which the step
  rebuilds the blocks and gathers the features and labels on the device, one batch
  or a group of ``G`` batches a step.

The train state is the model and its optimizer. An optimizer is passed as a factory
that takes the parameters, e.g. ``functools.partial(torch.optim.Adam, lr=1e-2)``,
as ``optax.adam(1e-2)`` is passed in the JAX package. Dropout masks are drawn from
the trainer's ``torch.Generator``, seeded from ``seed`` on the training device. Both
trainers run on a CUDA device unless the caller asks for the CPU (``device="cpu"``).

The packed steps, the group step and the scanned step are the counterparts of the
JAX package's jitted and scanned steps. On a CUDA device each is a CUDA graph
(``cuda_graph.GraphedStep``), replayed once a call, unless the caller asks for the
eager step (``cuda_graph=False``, for comparisons); the eager step is the plain
version, and the CPU runs it. Their optimizer must be capturable (``GRAPH_ADAM``).
"""
from __future__ import annotations

import itertools
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from dgll_tpu_torch.sampling.base import Block
from dgll_tpu_torch.train.cuda_graph import GraphedStep
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


def blocks_from_packed(ids: torch.Tensor, mask: torch.Tensor, fanouts) -> List[Block]:
    """The outermost-first ``Block`` list of a batch's frontier-growth buffers
    (``NeighborSampler.sample_packed``): views of ``ids`` and of ``mask`` cast once to
    bool, no other copy. ``ids``/``mask`` are ``[n_final]``; the batch size follows
    from the growth, ``sizes[k + 1] = sizes[k] * (1 + reversed(fanouts)[k])``."""
    fanouts = [int(f) for f in fanouts]
    total_grow = 1
    for f in fanouts:
        total_grow *= 1 + f
    n_k = ids.shape[0] // total_grow
    mask_b = mask.to(torch.bool)
    blocks: List[Block] = []
    for f in reversed(fanouts):
        n_next = n_k * (1 + f)
        blocks.insert(0, Block(dst_ids=ids[:n_k], src_ids=ids[:n_next],
                               neigh_mask=mask_b[n_k:n_next].view(n_k, f),
                               dst_mask=mask_b[:n_k], fanout=f, n_dst=int(n_k)))
        n_k = n_next
    return blocks


def _block_loss(state: TrainState, blocks, x, y, m, generator, loss_fn) -> torch.Tensor:
    """Forward, loss and backward of one batch, the gradients set anew."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(state.model(list(blocks), x, generator=generator), y, m)
    loss.backward()
    return loss.detach()


def _packed_loss(state, ids, mask, feats, labels, generator, fanouts, loss_fn):
    blocks = blocks_from_packed(ids, mask, fanouts)
    x = feats.index_select(0, blocks[0].src_ids)
    y = labels.index_select(0, blocks[-1].dst_ids)
    return _block_loss(state, blocks, x, y, blocks[-1].dst_mask, generator, loss_fn)


def _written_by_step(state: TrainState) -> List[torch.Tensor]:
    """The tensors an optimizer step writes: the parameters and the optimizer's state
    (for a capturable Adam its step count too)."""
    out = list(state.model.parameters())
    for s in state.optimizer.state.values():
        out += [t for t in s.values() if isinstance(t, torch.Tensor)]
    return out


@torch.no_grad()
def _keep_if(valid: torch.Tensor, state: TrainState, before: dict) -> None:
    """Where ``valid`` (a bool device scalar) is false, put back the tensors
    ``before`` holds (``id -> copy``; state the step created starts from zero, Adam's
    initial state), without a host read: ``t * v + before * (1 - v)``, which selects
    exactly between finite values."""
    v = valid.to(torch.float32)
    by_device: dict = {}
    for t in _written_by_step(state):
        saved = before.get(id(t))
        by_device.setdefault(t.device, ([], []))
        by_device[t.device][0].append(t)
        by_device[t.device][1].append(torch.zeros_like(t) if saved is None else saved)
    for dev, (now, saved) in by_device.items():
        vd = v.to(dev)
        torch._foreach_mul_(now, vd)
        torch._foreach_mul_(saved, 1.0 - vd)
        torch._foreach_add_(now, saved)


def make_packed_block_step(fanouts, loss_fn=masked_nll_loss,
                           cuda_graph: Optional[bool] = None):
    """Minibatch train step over the packed batch form: ``step(state, ids, mask,
    feats, labels, generator) -> (state, loss)``. The host ships only ``(ids, mask)``
    (two copies a batch instead of four a block); the step rebuilds the blocks and
    gathers the features and labels on the device. ``feats``/``labels`` are the full
    device tensors. On a CUDA device the step is a CUDA graph (``GraphedStep``)."""
    fanouts = [int(f) for f in fanouts]

    def body(state, generator, inputs, feats, labels):
        loss = _packed_loss(state, *inputs, feats, labels, generator, fanouts, loss_fn)
        state.optimizer.step()
        return (loss,)

    graphed = GraphedStep(body, cuda_graph)

    def step(state: TrainState, ids, mask, feats, labels, generator):
        (loss,) = graphed(state, generator, (ids, mask), feats, labels)
        state.step += 1
        return state, loss

    return step


def make_packed_group_step(fanouts, loss_fn=masked_nll_loss,
                           cuda_graph: Optional[bool] = None):
    """``G`` packed train steps in one call: ``steps(state, ids_g [G, n], mask_g [G,
    n], feats, labels, generator) -> (state, loss sum, valid batches)``, the sums
    device scalars. On a CUDA device the ``G`` steps are one CUDA graph, so a group
    costs one replay and two copies.

    A batch whose mask is all zero (the padding of a last, short group) adds no loss
    and leaves the parameters and the optimizer's state, its step count included, as
    they were (Adam would otherwise move on zero gradients), so a padded group trains
    as the same batches stepped one by one. The device alone knows which batches are
    padding, so ``state.step`` is the caller's to advance.
    """
    fanouts = [int(f) for f in fanouts]

    def body(state, generator, inputs, feats, labels):
        ids_g, mask_g = inputs
        lsum = torch.zeros((), device=feats.device)
        nvalid = torch.zeros((), device=feats.device)
        for ids, mask in zip(ids_g, mask_g):
            valid = mask.to(torch.bool).any()
            with torch.no_grad():
                now = _written_by_step(state)
                before = dict(zip(map(id, now), torch._foreach_mul(now, 1.0)))  # copies
            loss = _packed_loss(state, ids, mask, feats, labels, generator, fanouts,
                                loss_fn)
            state.optimizer.step()
            _keep_if(valid, state, before)
            lsum = lsum + torch.where(valid, loss, 0.0)
            nvalid = nvalid + valid.to(torch.float32)
        return lsum, nvalid

    graphed = GraphedStep(body, cuda_graph)

    def steps(state: TrainState, ids_g, mask_g, feats, labels, generator):
        lsum, nvalid = graphed(state, generator, (ids_g, mask_g), feats, labels)
        return state, lsum, nvalid

    return steps


_BLOCK_FIELDS = ("dst_ids", "src_ids", "neigh_mask", "dst_mask")


def make_scanned_block_step(loss_fn=masked_nll_loss, cuda_graph: Optional[bool] = None):
    """``K`` train steps in one call over batches stacked on a leading axis
    (``stack_batches``): ``steps(state, blocks_k, x_k, labels_k, mask_k, generator)
    -> (state, losses [K])``. On a CUDA device the ``K`` steps are one CUDA graph over
    the stacked tensors, the counterpart of the JAX package's ``lax.scan``."""

    def body(state, generator, inputs):
        *block_t, x_k, y_k, m_k = inputs
        losses = []
        for k in range(x_k.shape[0]):
            blocks = []
            for i in range(0, len(block_t), len(_BLOCK_FIELDS)):
                fields = dict(zip(_BLOCK_FIELDS, (t[k] for t in block_t[i:i + 4])))
                n_dst, fanout = fields["neigh_mask"].shape
                blocks.append(Block(**fields, fanout=fanout, n_dst=n_dst))
            losses.append(_block_loss(state, blocks, x_k[k], y_k[k], m_k[k], generator,
                                      loss_fn))
            state.optimizer.step()
        return (torch.stack(losses),)

    graphed = GraphedStep(body, cuda_graph)

    def steps(state: TrainState, blocks_k, x_k, labels_k, mask_k, generator):
        inputs = (*[getattr(b, f) for b in blocks_k for f in _BLOCK_FIELDS],
                  x_k, labels_k, mask_k)
        (losses,) = graphed(state, generator, inputs)
        state.step += int(x_k.shape[0])
        return state, losses

    return steps


def stack_batches(batches):
    """Stack ``K`` same-shape ``(blocks, x, y, mask)`` batches on a new leading axis
    for ``make_scanned_block_step``; the blocks' static fields must match."""
    first = batches[0][0]
    for blocks, *_ in batches:
        if [(b.fanout, b.n_dst) for b in blocks] != [(b.fanout, b.n_dst) for b in first]:
            raise ValueError("stack_batches: the batches' blocks differ in shape")
    blocks_k = [replace(b, **{f: torch.stack([getattr(bs[0][i], f) for bs in batches])
                              for f in _BLOCK_FIELDS})
                for i, b in enumerate(first)]
    x_k, y_k, m_k = (torch.stack([b[j] for b in batches]) for j in (1, 2, 3))
    return blocks_k, x_k, y_k, m_k


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


def measure_link(device="cuda", size_bytes: int = 4 << 20) -> tuple:
    """One probe of the host-to-device link: ``(bandwidth bytes/s, round trip s)``,
    which ``choose_packed_group`` routes by.

    The round trip is the mean host time of a tiny device reduction read back to the
    host (4 after one warm-up). The bandwidth is ``size_bytes`` copied from pinned host
    memory (the packed loader's staging) over the copy's own time: CUDA events around
    it on a CUDA device, the host clock around it on the CPU. The JAX package times
    the copy and a read of its value on the host clock and subtracts the round trip,
    clamping the difference at 1e-6 s, which reports about 4 TB/s where the round
    trip swallows the copy; timing the copy alone needs no subtraction and no clamp.
    """
    dev = torch.device(device)
    host = torch.ones(size_bytes // 4)
    if dev.type == "cuda":
        host = host.pin_memory()
    dst = torch.empty(host.shape, device=dev)
    dst.copy_(host)  # warm: the allocator and the copy path
    one = torch.zeros(8, device=dev)
    float(one.sum())  # warm: the reduction's launch
    n = 4
    t0 = time.perf_counter()
    for _ in range(n):
        float(one.sum())
    rtt = (time.perf_counter() - t0) / n
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(host, non_blocking=True)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        dst.copy_(host)
        seconds = time.perf_counter() - t0
    return size_bytes / max(seconds, 1e-9), rtt


def choose_packed_group(payload_bytes: int, bandwidth: float, rtt: float,
                        max_group: int = 8) -> int:
    """Group size for the packed epoch, from measured link characteristics.

    Grouping runs G batches a dispatch, saving about (G-1) round trips a group: a
    win only where the fixed round trip outweighs the time of a batch's payload on
    the link. On a bandwidth-bound link grouping buys nothing and costs pipeline
    overlap, so it routes to group 1 there.
    """
    transfer_s = payload_bytes / max(bandwidth, 1.0)
    if transfer_s >= rtt:
        return 1          # bandwidth-bound: RTT amortisation cannot win
    # RTT-bound: amortise until the grouped payload time reaches ~1 RTT
    g = int(min(max_group, max(1.0, rtt / max(transfer_s, 1e-9))))
    return max(g, 1)


def _nbytes(t) -> int:
    return t.nbytes if isinstance(t, np.ndarray) else t.element_size() * t.numel()


class MiniBatchTrainer:
    def __init__(self, model: torch.nn.Module, optimizer: Callable,
                 loss_fn=masked_nll_loss, seed: int = 0, device="cuda",
                 cuda_graph: Optional[bool] = None):
        """``cuda_graph``: the packed steps of ``run_epoch_packed`` replay CUDA graphs
        (the default on a CUDA device; the optimizer must be capturable) or run
        eagerly."""
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.device = torch.device(device)
        self.cuda_graph = cuda_graph
        self.step = make_block_step(loss_fn)
        self.evaluate = make_block_eval()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._packed_steps: dict = {}
        self._link: Optional[tuple] = None  # measure_link's probe, taken once
        self.last_group = 1

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

    def _stack(self, items) -> torch.Tensor:
        if isinstance(items[0], np.ndarray):
            return torch.from_numpy(np.stack(items)).to(self.device)
        return torch.stack([self._on_device(t) for t in items])

    def run_epoch_packed(self, state: TrainState, loader, features, labels, fanouts,
                         group=1) -> tuple:
        """One epoch over a ``packed=True`` loader: ``(state, mean loss, seconds)``.
        Each batch is just ``(ids, mask)``; the step rebuilds the blocks and gathers
        the features and labels on the device (``make_packed_block_step``), one CUDA
        graph replay a batch on a CUDA device.

        ``group > 1`` runs ``group`` batches a step (``make_packed_group_step``), one
        replay and two copies a group; the last group is padded with all-zero-mask
        batches, whose updates are suppressed, so the training is unchanged.
        ``group="auto"`` probes the link once (``measure_link``, kept in
        ``self._link``) and picks the group from it and the first batch's payload
        (``choose_packed_group``). The group that ran is ``self.last_group``. The
        steps are kept by ``(fanouts, group)``; the loss is summed on the device and
        read once, at the end of the epoch.
        """
        features, labels = self._on_device(features), self._on_device(labels)
        if group == "auto":
            if self._link is None:
                # before the loader's producer threads start, whose host work would
                # otherwise count as round trip
                self._link = measure_link(self.device)
            it = iter(loader)
            first = next(it, None)
            if first is None:
                self.last_group = 1
                return state, 0.0, 0.0
            group = choose_packed_group(_nbytes(first[0]) + _nbytes(first[1]), *self._link)
            loader = itertools.chain([first], it)
        self.last_group = group = int(group)
        key = (tuple(int(f) for f in fanouts), group)
        if key not in self._packed_steps:
            make = make_packed_group_step if group > 1 else make_packed_block_step
            self._packed_steps[key] = make(key[0], self.loss_fn, cuda_graph=self.cuda_graph)
        step = self._packed_steps[key]
        total = n_valid = None
        nb = 0
        t0 = time.perf_counter()
        if group <= 1:
            for ids, mask in loader:
                state, loss = step(state, ids, mask, features, labels, self.generator)
                total = loss if total is None else total + loss
                nb += 1
            total = float(total) if total is not None else 0.0
            return state, total / max(nb, 1), time.perf_counter() - t0

        def flush(buf):
            nonlocal state, total, n_valid
            n_real = len(buf)
            buf = buf + [(np.zeros_like(buf[0][0]), np.zeros_like(buf[0][1]))
                         if isinstance(buf[0][0], np.ndarray) else
                         (torch.zeros_like(buf[0][0]), torch.zeros_like(buf[0][1]))
                         ] * (group - n_real)
            state, lsum, nv = step(state, self._stack([b[0] for b in buf]),
                                   self._stack([b[1] for b in buf]), features, labels,
                                   self.generator)
            state.step += n_real
            # summed on the device: a host read here would wait for every group
            total = lsum if total is None else total + lsum
            n_valid = nv if n_valid is None else n_valid + nv

        buf = []
        for batch in loader:
            buf.append(batch)
            if len(buf) == group:
                flush(buf)
                buf = []
        if buf:
            flush(buf)
        total = float(total) if total is not None else 0.0
        n_valid = float(n_valid) if n_valid is not None else 0.0
        return state, total / max(n_valid, 1.0), time.perf_counter() - t0

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
