"""Minibatch data loader with host-side sampling overlapped against device compute.

Counterpart of ``dgll_tpu/dataloader/dataloader.py``. One or more producer threads
sample the next batches (the C++ sampler releases the GIL) and, where a ``device``
is given, move each batch's blocks there, while the consumer's step runs on the
device; the bounded queue (``prefetch``) is the backpressure. Yields
``(input_nodes, output_nodes, blocks)`` per batch: ``input_nodes`` and
``output_nodes`` stay host numpy, the blocks are on ``device`` (or the host).
``packed=True`` yields only the frontier-growth buffers every block is a view of,
``(ids int32 [n_final], mask uint8 [n_final])``, for the packed train steps: two
copies a batch instead of four a block.

The producers' copies go to the current stream of their thread, which is the
device's default stream unless a caller set another, the stream the consumer's
steps run on. A batch's copies are queued before the producer hands the batch
over, so no step that reads them can be queued ahead of them. The packed buffers
are staged in a ring of pinned host buffers allocated once (``PinnedRing``); a
slot is refilled only after the copies that read it have run.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch

from dgll_tpu_torch.sampling.base import BaseSampler, HostGraph


class DataLoader:
    def __init__(
        self,
        g,
        seeds: Sequence[int],
        sampler: BaseSampler,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = False,
        prefetch: int = 2,
        device=None,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        n_producers: int = 1,
        packed: bool = False,
    ):
        """``num_shards``/``shard_index`` split the seeds per rank (every
        ``num_shards``-th seed from ``shard_index``). ``n_producers`` > 1 samples on
        several host threads at once; the batch order within an epoch is then
        nondeterministic. ``packed=True`` yields ``(ids, mask)`` frontier-growth
        buffers instead of ``(input_nodes, output_nodes, blocks)``, host numpy, or
        tensors on ``device``; consume them with ``make_packed_block_step`` or
        ``MiniBatchTrainer.run_epoch_packed`` (the sampler needs ``sample_packed``)."""
        self.host_g = g if isinstance(g, HostGraph) else HostGraph.from_graph(g)
        self.seeds = np.asarray(seeds, np.int64)
        if num_shards > 1:
            self.seeds = self.seeds[shard_index::num_shards]
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = max(int(prefetch), 0)
        self.device = None if device is None else torch.device(device)
        self.n_producers = max(int(n_producers), 1)
        self.packed = bool(packed)
        self._rng = np.random.default_rng(seed)
        self._ring = None
        if self.packed and self.device is not None and self.device.type == "cuda":
            # a slot for each batch the queue holds, each producer fills and the
            # consumer holds, and one more
            self._ring = PinnedRing(self.prefetch + self.n_producers + 2)

    def __len__(self) -> int:
        n = len(self.seeds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self):
        order = (self._rng.permutation(len(self.seeds)) if self.shuffle
                 else np.arange(len(self.seeds)))
        seeds = self.seeds[order]
        for i in range(len(self)):
            yield seeds[i * self.batch_size: (i + 1) * self.batch_size]

    def _make(self, batch_seeds):
        if self.packed:
            ids, mask = self.sampler.sample_packed(self.host_g, batch_seeds,
                                                   pad_to=self.batch_size)
            if self._ring is not None:
                return self._ring.copy((ids, mask), self.device)
            if self.device is not None:
                return torch.from_numpy(ids).to(self.device), torch.from_numpy(mask).to(
                    self.device)
            return ids, mask
        inp, out, blocks = self.sampler.sample(self.host_g, batch_seeds,
                                               pad_to=self.batch_size)
        if self.device is not None:
            blocks = [b.to(self.device) for b in blocks]
        return inp, out, blocks

    def __iter__(self) -> Iterator:
        if self.prefetch == 0 and self.n_producers <= 1:
            for bs in self._batches():
                yield self._make(bs)
            return

        q: "queue.Queue" = queue.Queue(maxsize=max(self.prefetch, 1))
        sentinel = object()
        err: list = []
        work = iter(list(self._batches()))
        work_lock = threading.Lock()

        def producer():
            try:
                while True:
                    with work_lock:
                        bs = next(work, None)
                    if bs is None:
                        return
                    q.put(self._make(bs))
            except BaseException as e:  # handed to the consumer
                err.append(e)
            finally:
                q.put(sentinel)

        threads = [threading.Thread(target=producer, daemon=True)
                   for _ in range(self.n_producers)]
        for t in threads:
            t.start()
        done = 0
        while done < self.n_producers:
            item = q.get()
            if item is sentinel:
                done += 1
                continue
            yield item
        for t in threads:
            t.join()
        if err:
            raise err[0]


class PinnedRing:
    """Pinned host buffers for host-to-device copies, allocated once and used in
    turn by any number of threads. ``copy`` stages arrays in a free slot and queues
    their copies on the current stream, then records an event behind them; the
    next ``copy`` into that slot waits for the event first, so no copy still in
    flight reads a buffer that is being refilled."""

    def __init__(self, n_slots: int):
        self._free: "queue.Queue" = queue.Queue()
        for _ in range(n_slots):
            self._free.put([None, torch.cuda.Event()])  # (pinned buffers, event)

    def copy(self, arrays, device) -> Tuple[torch.Tensor, ...]:
        slot = self._free.get()
        try:
            bufs, event = slot
            event.synchronize()  # the copies that last read this slot have run
            if bufs is None or any(b.shape != a.shape or b.numpy().dtype != a.dtype
                                   for b, a in zip(bufs, arrays)):
                bufs = slot[0] = tuple(torch.from_numpy(np.empty_like(a)).pin_memory()
                                       for a in arrays)
            out = []
            for b, a in zip(bufs, arrays):
                np.copyto(b.numpy(), a)
                out.append(torch.empty(b.shape, dtype=b.dtype, device=device))
                out[-1].copy_(b, non_blocking=True)
            event.record(torch.cuda.current_stream(device))
        finally:
            self._free.put(slot)
        return tuple(out)
