"""Device-resident minibatch training: sampling, feature gather and step on the card.

Counterpart of ``dgll_tpu/train/device_pipeline.py`` (the single-device parts). The
graph's CSR (or, for the layer-wise samplers, its normalised Laplacian, a
``DeviceLap``), the features and the labels live in device memory; each batch's
sample is a few gathers (``sampling/device_sampler.py``), or gathers, a sort and
binary searches (``sampling/device_layerwise.py``). The JAX package
runs a whole epoch as one ``lax.scan`` dispatch. Its counterpart here is a CUDA
graph of the fixed-shape batch step, captured once and replayed once a batch: the
host enqueues one graph launch a batch and reads the epoch's loss once.

An epoch's randomness is a set of explicit tensors (``EpochDraws``): the permutation
of the padded seeds and every layer's uniforms for every batch, drawn up front from
the runner's generator, one call a tensor. A batch step is then a deterministic
function of its slice, which the step selects with a device scalar that it advances
itself, so the captured graph reads a new slice on every replay and the host does
not touch it. Tests pass the permutation and the uniforms of the JAX package's key
chain and get its batches exactly.

On a CUDA device the step runs as a graph replay unless the caller asks for the
eager step (``cuda_graph=False``, for comparisons); a capture or a replay that fails
raises, and nothing falls back to the eager step. The eager step is the plain version
of the same function, and the CPU runs it. The optimizer of a captured step must be
capturable (``capturable=True``; ``GRAPH_ADAM`` is the bench's choice).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

# modules, not names: ``parallel.dp`` imports this package's trainer
from dgll_tpu_torch.parallel import dp
from dgll_tpu_torch.parallel import mesh as meshes
from dgll_tpu_torch.sampling.device_layerwise import MODES as LAYERWISE
from dgll_tpu_torch.sampling.device_layerwise import sample_blocks_device_layerwise
from dgll_tpu_torch.sampling.device_sampler import layer_sizes, sample_blocks_device
from dgll_tpu_torch.train import cuda_graph
from dgll_tpu_torch.train.metrics import masked_nll_loss
from dgll_tpu_torch.train.trainer import TrainState, create_train_state


def make_sample_fn(fanouts: Sequence[int], window: bool = False,
                   sampler: str = "neighbor") -> Callable:
    """Device-sampling callable ``(graph, seeds, mask, generator=None, draws=None) ->
    (input_nodes, output_nodes, blocks)``: ``neighbor``, uniform fanout over a
    ``DeviceCSR``; ``fastgcn`` or ``ladies``, layer-wise importance draws over a
    ``DeviceLap``, with ``fanouts`` read as the layer sizes, outermost first."""
    fanouts = [int(f) for f in fanouts]
    if sampler == "neighbor":
        def fn(csr, seeds, mask, generator=None, draws=None):
            return sample_blocks_device(csr, seeds, mask, fanouts, generator, draws,
                                        window=window)
    elif sampler in LAYERWISE:
        def fn(lap, seeds, mask, generator=None, draws=None):
            return sample_blocks_device_layerwise(lap, seeds, mask, fanouts, generator,
                                                  draws, mode=sampler)
    else:
        raise ValueError(f"unknown device sampler {sampler!r}")
    return fn


def draw_shapes(batch_size: int, fanouts: Sequence[int], window: bool = False,
                sampler: str = "neighbor") -> List:
    """The shapes of one batch's uniforms, layer by layer, innermost first: a tuple
    of shapes where a layer reads several tensors, else one shape. ``neighbor``:
    ``(n, fanout)``, or ``((n,), (n, fanout))`` in window mode; ``fastgcn``:
    ``((s,), (s,))``; ``ladies``: ``(s,)``."""
    rev = list(reversed([int(f) for f in fanouts]))
    if sampler == "neighbor":
        return [((n,), (n, f)) if window else (n, f)
                for n, f in zip(layer_sizes(batch_size, fanouts), rev)]
    return [((s,), (s,)) if sampler == "fastgcn" else (s,) for s in rev]


def _is_several(shape) -> bool:
    return isinstance(shape[0], tuple)


@dataclass
class EpochDraws:
    """An epoch's randomness: ``order`` [n_batches * batch_size] int64, the
    permutation of the padded seeds; ``uniforms[li]``, layer ``li``'s uniforms for
    every batch (innermost layer first), each of ``draw_shapes``' shapes with a
    leading ``n_batches``."""

    order: torch.Tensor
    uniforms: List


def draw_uniforms(n_batches: int, batch_size: int, fanouts: Sequence[int], window: bool,
                  generator: Optional[torch.Generator], device,
                  sampler: str = "neighbor") -> List:
    """``EpochDraws.uniforms`` from ``generator``: one ``torch.rand`` a uniform
    tensor, innermost layer first."""
    def rand(shape):
        return torch.rand(n_batches, *shape, generator=generator, device=device)

    return [tuple(rand(sh) for sh in shape) if _is_several(shape) else rand(shape)
            for shape in draw_shapes(batch_size, fanouts, window, sampler)]


def draw_epoch(n_batches: int, batch_size: int, fanouts: Sequence[int], window: bool,
               generator: Optional[torch.Generator], device,
               sampler: str = "neighbor") -> EpochDraws:
    """An epoch's draws from ``generator``: ``randperm``, then the uniforms
    (``draw_uniforms``)."""
    order = torch.randperm(n_batches * batch_size, generator=generator, device=device)
    return EpochDraws(order, draw_uniforms(n_batches, batch_size, fanouts, window,
                                           generator, device, sampler))


def _tensors(u) -> tuple:
    return u if isinstance(u, tuple) else (u,)


def _pick(u, i: torch.Tensor):
    """Batch ``i``'s slice (``i`` a 1-element device tensor) of one layer's draws."""
    picked = tuple(t.index_select(0, i)[0] for t in _tensors(u))
    return picked if isinstance(u, tuple) else picked[0]


def padded_seeds(nodes, batch_size: int):
    """``(seeds int32, mask bool, n_batches)``: ``nodes`` padded with id 0 (mask 0)
    to a whole number of batches, at least one."""
    nodes = np.asarray(nodes, np.int64)
    n_batches = max(1, -(-len(nodes) // batch_size))
    seeds = np.zeros(n_batches * batch_size, np.int32)
    seeds[: len(nodes)] = nodes
    mask = np.zeros(n_batches * batch_size, bool)
    mask[: len(nodes)] = True
    return torch.from_numpy(seeds), torch.from_numpy(mask), n_batches


def make_device_eval_fn(model: torch.nn.Module, fanouts: Sequence[int], batch_size: int,
                        n_batches: int, window: bool = False, sampler: str = "neighbor",
                        feat_dtype: Optional[torch.dtype] = None):
    """Sampled evaluation sweep: ``evaluate(csr, feats, seeds, seed_mask,
    generator=None, draws=None) -> (pred int32 [total], valid bool [total])``, each
    batch sampled on the device (from ``generator``, or from ``draws[i]``, batch
    ``i``'s per-layer uniforms), its gathered features cast to ``feat_dtype`` where
    given, and the model applied in eval mode. Eager, one batch after the other, and
    deterministic given the generator's seed."""
    sample_fn = make_sample_fn(fanouts, window, sampler)
    b = int(batch_size)

    @torch.no_grad()
    def evaluate(csr, feats, seeds, seed_mask, generator=None, draws=None):
        was_training = model.training
        model.eval()
        preds, valid = [], []
        try:
            for i in range(n_batches):
                _, _, blocks = sample_fn(csr, seeds[i * b:(i + 1) * b],
                                         seed_mask[i * b:(i + 1) * b], generator,
                                         None if draws is None else draws[i])
                x = feats.index_select(0, blocks[0].src_ids)
                if feat_dtype is not None:
                    x = x.to(feat_dtype)
                preds.append(model(blocks, x).argmax(-1).to(torch.int32))
                valid.append(blocks[-1].dst_mask)
        finally:
            model.train(was_training)
        return torch.cat(preds), torch.cat(valid)

    return evaluate


class DeviceEpochRunner:
    """Device-resident epochs of minibatch training.

    ``csr`` is the sampler's graph: a ``DeviceCSR`` for ``sampler="neighbor"``, a
    ``DeviceLap`` for ``fastgcn`` and ``ladies`` (``fanouts`` then the layer sizes,
    outermost first).

    Usage::

        runner = DeviceEpochRunner(model, functools.partial(torch.optim.Adam, lr=1e-3,
                                   **GRAPH_ADAM), csr, fanouts=[15, 10],
                                   batch_size=1024, train_nodes=train_nodes)
        state = runner.init_state(feats)
        state, loss = runner.run_epoch(state, feats, labels)

    ``feats``/``labels`` are tensors on the CSR's device covering all ``csr.n_node``
    rows; ``optimizer`` is a factory taking the parameters. Dropout masks and the
    epochs' draws come from the runner's generator (``seed``). ``cuda_graph``: replay
    a captured step (the default on a CUDA device) or run the eager step; the CPU
    runs the eager step only. ``feat_dtype`` (the model's compute type, e.g.
    bfloat16): each batch's gathered features, and exact inference's, are cast to it
    before the model, as the JAX runner's ``feat_dtype`` does.
    """

    def __init__(self, model: torch.nn.Module, optimizer: Callable, csr,
                 fanouts: Sequence[int], batch_size: int, train_nodes,
                 loss_fn: Callable = masked_nll_loss, seed: int = 0,
                 window: bool = False, sampler: str = "neighbor",
                 cuda_graph: Optional[bool] = None,
                 feat_dtype: Optional[torch.dtype] = None):
        self.model, self.optimizer, self.csr = model, optimizer, csr
        self.feat_dtype = feat_dtype
        self.device = csr.device
        self.fanouts = [int(f) for f in fanouts]
        self.batch_size = int(batch_size)
        self.loss_fn = loss_fn
        self.window = bool(window)
        self.sampler = sampler
        self.sample_fn = make_sample_fn(self.fanouts, window, sampler)
        seeds, mask, self.n_batches = padded_seeds(train_nodes, self.batch_size)
        self.seeds, self.seed_mask = seeds.to(self.device), mask.to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.cuda_graph = self.device.type == "cuda" if cuda_graph is None else cuda_graph
        if self.cuda_graph and self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {self.device}")
        self._buffers(self.batch_size)
        self._graph = None
        self._graph_key = None
        self._eval_cache = {}

    def _buffers(self, b: int) -> None:
        """The epoch's inputs and outputs for steps of ``b`` seeds, at fixed
        addresses that a graph reads."""
        nb = self.n_batches
        self._seeds = torch.zeros((nb, b), dtype=torch.int32, device=self.device)
        self._mask = torch.zeros((nb, b), dtype=torch.bool, device=self.device)
        self._draws = [
            tuple(torch.zeros((nb, *sh), device=self.device) for sh in shape)
            if _is_several(shape) else torch.zeros((nb, *shape), device=self.device)
            for shape in draw_shapes(b, self.fanouts, self.window, self.sampler)]
        self._i = torch.zeros(1, dtype=torch.long, device=self.device)
        self.batch_losses = torch.zeros(nb, device=self.device)

    # -- training ------------------------------------------------------------
    def init_state(self, feats=None) -> TrainState:
        """The model on the CSR's device and a fresh optimizer. The model holds its
        parameters from its construction, so no batch is traced for them."""
        return create_train_state(self.model.to(self.device), self.optimizer)

    def _step(self, state: TrainState, feats, labels, marks=None) -> None:
        """Batch ``self._i`` of the epoch's buffers: sample, gather, forward, loss,
        backward and optimizer step; its loss goes to ``batch_losses[i]`` and ``i``
        advances. ``marks``: 6 CUDA events recorded around the five phases."""
        def mark(k):
            if marks is not None:
                marks[k].record()

        i = self._i
        mark(0)
        _, _, blocks = self.sample_fn(self.csr, _pick(self._seeds, i),
                                      _pick(self._mask, i),
                                      draws=[_pick(u, i) for u in self._draws])
        mark(1)
        x = feats.index_select(0, blocks[0].src_ids)
        if self.feat_dtype is not None:
            x = x.to(self.feat_dtype)
        y = labels.index_select(0, blocks[-1].dst_ids)
        mark(2)
        loss = self.loss_fn(state.model(blocks, x, generator=self.generator), y,
                            blocks[-1].dst_mask)
        mark(3)
        loss.backward()
        mark(4)
        state.optimizer.step()
        self.batch_losses.index_copy_(0, i, loss.detach().float().view(1))
        i.add_(1)
        mark(5)

    def _eager_step(self, state: TrainState, feats, labels) -> None:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        self._step(state, feats, labels)

    def _load_draws(self, draws: EpochDraws) -> None:
        self._seeds.copy_(self.seeds.index_select(0, draws.order).view_as(self._seeds))
        self._mask.copy_(self.seed_mask.index_select(0, draws.order).view_as(self._mask))
        for buf, u in zip(self._draws, draws.uniforms):
            for b, t in zip(_tensors(buf), _tensors(u)):
                b.copy_(t)

    def draw_epoch(self) -> EpochDraws:
        """The next epoch's draws from the runner's generator."""
        return draw_epoch(self.n_batches, self.batch_size, self.fanouts, self.window,
                          self.generator, self.device, self.sampler)

    def capture(self, state: TrainState, feats, labels, marks=None) -> "torch.cuda.CUDAGraph":
        """Capture the step on the current buffers as a CUDA graph
        (``cuda_graph.capture``: eager warm-up steps on a side stream, then the
        parameters, optimizer state and generator put back), and rewind the batch
        index. The runner's generator is registered with the graph, so every replay
        draws new dropout masks. ``marks``: see ``_step``."""
        i0 = self._i.clone()

        def warmup():
            self._i.zero_()  # an epoch may hold fewer batches than the warm-up
            self._eager_step(state, feats, labels)

        graph, _ = cuda_graph.capture(state, self.generator,
                                      lambda: self._step(state, feats, labels, marks),
                                      warmup)
        self._i.copy_(i0)
        return graph

    def load_epoch(self, draws: Optional[EpochDraws] = None) -> None:
        """Put an epoch's draws (from the runner's generator where None) into the
        step's buffers and rewind to its first batch."""
        self._load_draws(self.draw_epoch() if draws is None else draws)
        self._i.zero_()

    def run_epoch(self, state: TrainState, feats, labels,
                  draws: Optional[EpochDraws] = None):
        """One epoch: ``(state, mean loss)``, the loss a device tensor; no host
        synchronisation inside it. ``draws``: the epoch's randomness, drawn from the
        runner's generator where None."""
        self.load_epoch(draws)
        if self.cuda_graph:
            key = (id(state.model), id(state.optimizer), feats.data_ptr(),
                   labels.data_ptr())
            if self._graph_key != key:
                self._graph = self.capture(state, feats, labels)
                self._graph_key = key
            for _ in range(self.n_batches):
                self._graph.replay()
        else:
            for _ in range(self.n_batches):
                self._eager_step(state, feats, labels)
        state.step += self.n_batches
        return state, self.batch_losses.mean()

    # -- evaluation -----------------------------------------------------------
    def _eval_fn(self, n_batches: int):
        if n_batches not in self._eval_cache:
            self._eval_cache[n_batches] = make_device_eval_fn(
                self.model, self.fanouts, self.batch_size, n_batches, self.window,
                self.sampler, self.feat_dtype)
        return self._eval_cache[n_batches]

    def predict_nodes(self, state: TrainState, feats, nodes, seed: int = 0,
                      draws=None) -> np.ndarray:
        """Argmax predictions for ``nodes`` by the sampled sweep, deterministic given
        ``seed`` (or given ``draws``, each batch's per-layer uniforms). Returns a
        ``[len(nodes)]`` int32 numpy array."""
        seeds, mask, nb = padded_seeds(nodes, self.batch_size)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        pred, _ = self._eval_fn(nb)(self.csr, feats, seeds.to(self.device),
                                    mask.to(self.device), gen, draws)
        return pred.cpu().numpy()[: len(nodes)]

    def evaluate_nodes(self, state: TrainState, feats, labels_np, nodes,
                       seed: int = 0) -> float:
        """Accuracy over ``nodes`` by the sampled sweep."""
        nodes = np.asarray(nodes, np.int64)
        if len(nodes) == 0:
            return 0.0
        pred = self.predict_nodes(state, feats, nodes, seed)
        return float((pred == np.asarray(labels_np)[nodes]).mean())

    def predict_nodes_exact(self, state: TrainState, graph, feats, nodes) -> np.ndarray:
        """Predictions with no sampling noise: one full-graph forward with the
        trained parameters (``train/exact_infer.py``), the features cast to the
        runner's ``feat_dtype``; ``graph`` is the full ``Graph``."""
        from dgll_tpu_torch.train.exact_infer import exact_predict

        return exact_predict(state.model, graph, feats, nodes, self.feat_dtype)

    def evaluate_nodes_exact(self, state: TrainState, graph, feats, labels_np,
                             nodes) -> float:
        nodes = np.asarray(nodes, np.int64)
        if len(nodes) == 0:
            return 0.0
        pred = self.predict_nodes_exact(state, graph, feats, nodes)
        return float((pred == np.asarray(labels_np)[nodes]).mean())


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s own stream (its uniforms and dropout masks)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


class DeviceDPEpochRunner(DeviceEpochRunner):
    """Data-parallel ``DeviceEpochRunner``: each rank samples its sub-batch of
    ``per_device_batch`` seeds on its device, and the gradients are summed over the
    ranks; the global batch is ``mesh.size * per_device_batch`` (counterpart of the
    JAX package's ``DeviceDPEpochRunner`` and ``make_device_dp_epoch_fn``).

    An epoch's permutation of its ``n_batches * mesh.size * per_device_batch`` padded
    seeds comes from the runner's generator, seeded alike on every rank, so every
    rank holds the same permutation and takes its slice ``[:, rank]`` of each batch:
    no seed is drawn twice or missed. The sampling uniforms and the dropout masks
    come from the rank's own generator (``rank_seed``), as the JAX package folds the
    axis index into both keys.

    The step's gradient is the sum of the ranks' gradients, and its loss their mean,
    as the JAX package's epoch computes them: inside its ``shard_map`` the gradient of
    the replicated parameters is already summed over the devices (the transpose of
    their broadcast), so its ``pmean`` leaves the sum. (The host DP step,
    ``parallel.dp``, whose ``shard_map`` does not check replication, averages.)

    On a CUDA device a batch is a replay of one CUDA graph (sample, gather, forward,
    backward, the gradients and the loss into one fixed buffer), the all-reduce of
    that buffer (a gloo collective cannot be captured), then a replay of a second
    graph (the optimizer step). ``cuda_graph=False`` and the CPU run the
    same three parts eagerly. ``time_collective``: record CUDA events around each
    all-reduce (``collective_ms``).
    """

    def __init__(self, model: torch.nn.Module, optimizer: Callable, csr,
                 fanouts: Sequence[int], per_device_batch: int, train_nodes, mesh: "meshes.Mesh",
                 loss_fn: Callable = masked_nll_loss, seed: int = 0,
                 window: bool = False, sampler: str = "neighbor",
                 cuda_graph: Optional[bool] = None,
                 feat_dtype: Optional[torch.dtype] = None,
                 time_collective: bool = False):
        self.mesh = mesh
        self.per_device_batch = int(per_device_batch)
        super().__init__(model, optimizer, csr, fanouts,
                         mesh.size * self.per_device_batch, train_nodes, loss_fn, seed,
                         window, sampler, cuda_graph, feat_dtype)
        self.rank_generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(seed, mesh.rank))
        self._flat: Optional[torch.Tensor] = None
        self.time_collective = time_collective and self.device.type == "cuda"
        self._events: list = []

    def _buffers(self, b: int) -> None:
        super()._buffers(self.per_device_batch)  # a step holds this rank's sub-batch

    def draw_epoch(self) -> EpochDraws:
        """The permutation from the shared generator, this rank's uniforms from its
        own."""
        order = torch.randperm(self.n_batches * self.batch_size, generator=self.generator,
                               device=self.device)
        return EpochDraws(order, draw_uniforms(
            self.n_batches, self.per_device_batch, self.fanouts, self.window,
            self.rank_generator, self.device, self.sampler))

    def _load_draws(self, draws: EpochDraws) -> None:
        nb, d, b = self.n_batches, self.mesh.size, self.per_device_batch

        def mine(t):
            return t.index_select(0, draws.order).view(nb, d, b)[:, self.mesh.rank]

        self._seeds.copy_(mine(self.seeds))
        self._mask.copy_(mine(self.seed_mask))
        for buf, u in zip(self._draws, draws.uniforms):
            for t_buf, t in zip(_tensors(buf), _tensors(u)):
                t_buf.copy_(t)

    def _grad_step(self, state: TrainState, feats, labels) -> None:
        """Batch ``i``'s sample, gather, forward, loss and backward; the gradients and
        the loss into ``self._flat``."""
        i = self._i
        _, _, blocks = self.sample_fn(self.csr, _pick(self._seeds, i), _pick(self._mask, i),
                                      draws=[_pick(u, i) for u in self._draws])
        x = feats.index_select(0, blocks[0].src_ids)
        if self.feat_dtype is not None:
            x = x.to(self.feat_dtype)
        y = labels.index_select(0, blocks[-1].dst_ids)
        loss = dp.local_backward(state, blocks, x, y, blocks[-1].dst_mask,
                              self.rank_generator, self.loss_fn)
        self._flat.copy_(dp.flat_grads(state, loss))

    def _reduce(self) -> None:
        if self.time_collective:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            meshes.all_reduce(self.mesh, self._flat)
            ev[1].record()
            self._events.append(ev)
        else:
            meshes.all_reduce(self.mesh, self._flat)

    def _apply_step(self, state: TrainState) -> None:
        """The optimizer step on the gradients summed over the ranks, the batch's
        loss (their mean); ``i`` advances."""
        self._flat[-1:].div_(self.mesh.size)
        dp.set_grads(state, self._flat)
        state.optimizer.step()
        self.batch_losses.index_copy_(0, self._i, self._flat[-1:])
        self._i.add_(1)

    def _capture_dp(self, state: TrainState, feats, labels) -> tuple:
        """The two graphs of a batch, after eager warm-up steps (whole batches, the
        all-reduce included); the state put back and the batch index rewound."""
        i0 = self._i.clone()

        def warmup():
            self._i.zero_()
            self._grad_step(state, feats, labels)
            self._reduce()
            self._apply_step(state)

        grads, _ = cuda_graph.capture(state, self.rank_generator,
                                      lambda: self._grad_step(state, feats, labels), warmup)
        apply, _ = cuda_graph.capture(state, self.rank_generator,
                                      lambda: self._apply_step(state))
        self._i.copy_(i0)
        return grads, apply

    def run_epoch(self, state: TrainState, feats, labels,
                  draws: Optional[EpochDraws] = None):
        """One epoch of this rank: ``(state, mean loss over the ranks)``. ``draws``:
        the permutation and this rank's uniforms (``draw_epoch`` where None)."""
        if self._flat is None:
            n = sum(p.numel() for p in state.model.parameters() if p.requires_grad)
            self._flat = torch.zeros(n + 1, device=self.device)
        self.load_epoch(draws)
        self._events = []
        if self.cuda_graph:
            key = (id(state.model), id(state.optimizer), feats.data_ptr(),
                   labels.data_ptr())
            if self._graph_key != key:
                self._graph = self._capture_dp(state, feats, labels)
                self._graph_key = key
                self._events = []
            grads, apply = self._graph
            for _ in range(self.n_batches):
                grads.replay()
                self._reduce()
                apply.replay()
        else:
            for _ in range(self.n_batches):
                self._grad_step(state, feats, labels)
                self._reduce()
                self._apply_step(state)
        state.step += self.n_batches
        return state, self.batch_losses.mean()

    def collective_ms(self) -> float:
        """The all-reduces' time in the last epoch, from the CUDA events around them
        (``time_collective``; synchronises)."""
        torch.cuda.synchronize(self.device)
        return sum(a.elapsed_time(b) for a, b in self._events)
