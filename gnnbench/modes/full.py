"""Full-batch training: ``train.make_full_batch_step``, one step an epoch.

Set-up: the traffic's graph on the card, copied once to the host for the port's
``Graph.from_edges`` and, where the architecture reads them (GAT), the kernel
layouts ``Graph.with_chunked`` (together the layout build), moved to the card; the
model and the CLI's optimizer with the benchmark's weights; the step's dropout
generator from the benchmark's seed. The check's three steps are the first three
calls of the step the window runs; one more step and a read of its loss warm up.

Window: steps back to back, as the CLI's ``FullBatchTrainer.fit`` queues them when
nothing reads a value between epochs, until ``seconds`` have passed on the host,
then a read of the last loss; ``full_epoch_ms`` is the window's milliseconds over
the steps it completed.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from gnnbench import arch as arches
from gnnbench import check, reference, traffic, weights
from gnnbench.modes import Base

TRACED_EPOCHS = 5


class Run(Base):
    def setup(self) -> None:
        from dgll_tpu_torch.graph import Graph
        from dgll_tpu_torch.train import create_train_state, make_full_batch_step

        t, dev = self.traffic, self.device
        self.mark("weights")
        self.data = d = traffic.make(t, self.seeds, dev)
        self.mark("data")
        src, dst = d.src.cpu().numpy(), d.dst.cpu().numpy()
        t0 = time.perf_counter()
        g = Graph.from_edges(src, dst, t.n_node)
        if self.port.NEEDS_LAYOUTS:
            g = g.with_chunked()
        self.graph = g.to(dev)
        self.layout_build_s = time.perf_counter() - t0
        del src, dst
        self.mark("layout")
        self.mask = torch.zeros(t.n_node, dtype=torch.bool, device=dev)
        self.mask[d.train_nodes] = True
        model = self.port.build(self.cfg, t.n_feat, t.n_class, self.seeds["program"])
        weights.load_into(model, self.weights)
        self.mark("model")
        self.state = create_train_state(model.to(dev), arches.optimizer(self.cfg, False))
        self.step = make_full_batch_step()
        self.gen = torch.Generator(device=dev).manual_seed(self.seeds["program"])
        self.mark("optimizer")
        self.prog = self._check_steps()
        self.mark("check steps")
        float(self._step())
        self.mark("warm-up step")

    def _step(self) -> torch.Tensor:
        self.state, loss = self.step(self.state, self.graph, self.data.feats,
                                     self.data.labels, self.mask, self.gen)
        return loss

    def _check_steps(self) -> check.Snapshot:
        params = dict(self.state.model.named_parameters())
        losses, seen = [], [self.weights]
        for k in range(3):
            losses.append(self._step())
            if k == 0:
                grad = self.first_grad(self.state.optimizer, params)
            seen.append(self.params_now(params))
        return check.trajectory([float(v) for v in losses], grad, seen)

    def window(self, seconds: float) -> dict:
        steps = 0
        t0 = time.perf_counter()
        while True:
            with torch.profiler.record_function("gnnbench.step"):
                loss = self._step()
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        with torch.profiler.record_function("gnnbench.loss_read"):
            last = float(loss)
        s = time.perf_counter() - t0
        self.win = {"seconds": s, "epochs": steps}
        return {"metrics": {"full_epoch_ms": {"value": s * 1e3 / steps, "unit": "ms"}},
                "attempted": steps,
                "failed": int(not np.isfinite(last))}

    def traced(self) -> None:
        def slice_():
            for _ in range(TRACED_EPOCHS):
                with torch.profiler.record_function("gnnbench.step"):
                    loss = self._step()
            with torch.profiler.record_function("gnnbench.loss_read"):
                float(loss)

        self.traced_slice(slice_)

    def flops_per_epoch(self) -> float:
        t, n, e = self.traffic, self.traffic.n_node, self.data.n_edge
        rows = [(n, n, e)] * self.cfg["n_layers"]
        return self.ref.train_flops(self.cfg, t.n_feat, t.n_class, rows)

    def free_program(self) -> None:
        self.state = self.graph = self.step = None

    def reference(self, follow=None, tf32: bool = False,
                  half_batch: bool = False) -> check.Snapshot:
        """The reference's three steps (``_reference_steps``), the edges in
        (destination, source) order; ``tf32``: the control; ``half_batch``: half of
        the train nodes (the first half of the benchmark's draw) left out of the loss
        (a fault)."""
        t, d = self.traffic, self.data
        key = d.dst * t.n_node + d.src
        order = torch.argsort(key)
        g = SimpleNamespace(src=d.src[order], dst=d.dst[order], n_node=t.n_node)
        del key, order
        mask = self.mask
        if half_batch:
            mask = torch.zeros_like(mask)
            mask[d.train_nodes[: t.n_train // 2]] = True
        gen = torch.Generator(device=self.device).manual_seed(self.seeds["program"])

        def loss_of(p, k):
            return reference.nll(self.ref.forward_full(self.cfg, p, g, d.feats, gen),
                                 d.labels, mask)

        return self._reference_steps(loss_of, tf32, follow)
