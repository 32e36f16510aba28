"""Train steps captured as CUDA graphs: the GPU form of the JAX package's ``jax.jit``
of a whole step (and, over several batches, of its ``lax.scan``).

A step that runs on fixed-shape device buffers is run a few times eagerly on a side
stream (cuBLAS handles, the allocator, the optimizer's lazily created state), then
captured once; the warm-up's and the capture's changes to the parameters, the
optimizer's state and the generator are put back, so the first replay starts from
the state the caller had. The generator that draws the step's dropout masks is
registered with the graph, so every replay draws new masks. The optimizer must be
capturable (``capturable=True``, e.g. ``GRAPH_ADAM``): its step count then lives on
the device. A capture or a replay that fails raises; nothing falls back to the eager
step.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

# Adam's options for a captured step: its step count and bias correction stay on the
# device (capturable), and one fused kernel updates every parameter
GRAPH_ADAM = dict(capturable=True, fused=True)
WARMUP_STEPS = 3  # eager steps on a side stream before a capture (cuBLAS, allocator)


def snapshot(state, generator: torch.Generator):
    """Copies of what a step changes: the parameters and buffers, the optimizer's
    state tensors and the generator's state."""
    params = [t.detach().clone() for t in state.model.state_dict().values()]
    opt = {id(t): t.clone() for s in state.optimizer.state.values()
           for t in s.values() if isinstance(t, torch.Tensor)}
    return params, opt, generator.get_state()


def restore(state, snap, generator: torch.Generator) -> None:
    """Put back, in place, what ``snapshot`` copied; optimizer state created since is
    zeroed (Adam's initial state)."""
    params, opt, gen = snap
    with torch.no_grad():
        for t, s in zip(state.model.state_dict().values(), params):
            t.copy_(s)
        for s in state.optimizer.state.values():
            for t in s.values():
                if not isinstance(t, torch.Tensor):
                    continue
                if id(t) in opt:
                    t.copy_(opt[id(t)])
                else:
                    t.zero_()
    generator.set_state(gen)


def capture(state, generator: torch.Generator, step: Callable[[], object],
            warmup: Optional[Callable[[], object]] = None):
    """``(graph, out)``: ``step()`` captured as a CUDA graph on the generator's
    device, after ``WARMUP_STEPS`` calls of ``warmup`` (default ``step``) on a side
    stream, with the state and the generator put back as they were; ``out`` is what
    ``step()`` returned during the capture, the tensors each replay overwrites."""
    if not all(g.get("capturable", False) for g in state.optimizer.param_groups):
        raise ValueError("a CUDA graph needs a capturable optimizer: build it with "
                         "capturable=True (GRAPH_ADAM)")
    device = generator.device
    snap = snapshot(state, generator)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for _ in range(WARMUP_STEPS):
            (warmup or step)()
    torch.cuda.current_stream(device).wait_stream(stream)
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(generator)
    # thread-local: a loader's producer threads go on pinning, allocating and
    # copying while the step is captured; in the default global mode any such call
    # from another thread invalidates the capture, depending on when it lands
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = step()
    restore(state, snap, generator)
    return graph, out


class GraphedStep:
    """``body(state, generator, inputs, *consts) -> tuple of tensors``, a train step
    on the tensors ``inputs`` that also reads ``consts`` (e.g. the full feature and
    label tensors), run eagerly or replayed as a CUDA graph.

    With ``cuda_graph`` (the default where the generator is on a CUDA device) the
    first call, and any call with another model, optimizer, generator, ``consts`` or
    input shapes, copies ``inputs`` into static device buffers and captures ``body``
    on them; every later call copies its inputs into those buffers and replays. The
    outputs come back as copies, which the next call does not touch. Without it,
    ``body`` runs as it is: the plain version, which the CPU runs.
    """

    def __init__(self, body: Callable, cuda_graph: Optional[bool] = None):
        self.body = body
        self.cuda_graph = cuda_graph
        self._key = None
        self._graph = self._inputs = self._outputs = None

    def __call__(self, state, generator: torch.Generator, inputs, *consts) -> tuple:
        device = generator.device
        inputs = tuple(torch.as_tensor(t) for t in inputs)
        use_graph = device.type == "cuda" if self.cuda_graph is None else self.cuda_graph
        if not use_graph:
            return self.body(state, generator, tuple(t.to(device) for t in inputs),
                             *consts)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {device}")
        key = (id(state.model), id(state.optimizer), id(generator),
               tuple(c.data_ptr() for c in consts),
               tuple((t.shape, t.dtype) for t in inputs))
        if key != self._key:
            self._graph = None  # the old graph's buffers go before the new capture
            self._inputs = tuple(torch.empty_like(t, device=device) for t in inputs)
            for buf, t in zip(self._inputs, inputs):
                buf.copy_(t)
            self._graph, self._outputs = capture(
                state, generator, lambda: self.body(state, generator, self._inputs, *consts))
            self._key = key
        else:
            for buf, t in zip(self._inputs, inputs):
                buf.copy_(t)
        self._graph.replay()
        return tuple(t.clone() for t in self._outputs)
