"""Minibatch training with sampling on the device: ``DeviceEpochRunner``.

Set-up: the traffic's graph, features, labels and train nodes on the card; the CSR
handed to the port as ``DeviceCSR.from_host_arrays`` (its layout build); the model
and the CLI's optimizer (capturable on a card) with the benchmark's weights; the
runner with the benchmark's dropout seed. Then the check's three steps: the runner
loads an epoch of the benchmark's own draws and captures its step, and the capture
is replayed batch by batch, the first three replays observed, to the epoch's end;
then one epoch of ``run_epoch`` (its own capture and draws) warms up the window's path.

Window: ``run_epoch`` after ``run_epoch``, each ending in a host read of its loss,
until ``seconds`` have passed; ``train_seeds_per_s`` is the real train seeds of the
epochs completed over the window's seconds. On the CPU (a dry run) the runner steps
eagerly and the check's steps are its eager steps.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from gnnbench import arch as arches
from gnnbench import check, counts, reference, traffic, weights
from gnnbench.modes import Base

PHASES = ("sampling", "gather", "forward", "backward", "optimizer")
TRACED_EPOCHS = 2


class Run(Base):
    def setup(self) -> None:
        from dgll_tpu_torch.sampling import DeviceCSR
        from dgll_tpu_torch.train import DeviceEpochRunner, EpochDraws

        t, dev = self.traffic, self.device
        self.mark("weights")
        self.data = d = traffic.make(t, self.seeds, dev)
        self.mark("data")
        indptr, csr_src = d.indptr.cpu().numpy(), d.csr_src.cpu().numpy()
        train_nodes = d.train_nodes.cpu().numpy()
        t0 = time.perf_counter()
        csr = DeviceCSR.from_host_arrays(indptr, csr_src, dev)
        self.layout_build_s = time.perf_counter() - t0
        del indptr, csr_src
        self.mark("layout")
        model = self.port.build(self.cfg, t.n_feat, t.n_class, self.seeds["program"])
        weights.load_into(model, self.weights)
        self.mark("model")
        opt = arches.optimizer(self.cfg, captured=dev.type == "cuda")
        self.runner = r = DeviceEpochRunner(
            model, opt, csr, list(t.fanouts), t.batch_size, train_nodes,
            seed=self.seeds["program"], window=True)  # block-window draws
        self.state = r.init_state(d.feats)
        self.mark("optimizer, runner")
        self.draws = self._draws()
        self.prog = self._check_steps(EpochDraws(*self.draws))
        self.mark("check steps (capture, an epoch of replays)")
        self._epoch()  # the window's path: its capture and one epoch
        self.mark("warm-up epoch")

    def _draws(self) -> tuple:
        """An epoch's block-window draws made by the benchmark: ``(order, uniforms)``
        as ``EpochDraws`` holds them, one ``torch.rand`` a tensor."""
        t, nb = self.traffic, self.runner.n_batches
        gen = torch.Generator(device=self.device).manual_seed(self.seeds["check"])
        order = torch.randperm(nb * t.batch_size, generator=gen, device=self.device)

        def rand(*shape):
            return torch.rand(nb, *shape, generator=gen, device=self.device)

        sizes = traffic.layer_sizes(t.batch_size, list(t.fanouts))
        uniforms = [(rand(n), rand(n, f)) for n, f in zip(sizes, reversed(t.fanouts))]
        return order, uniforms

    def _check_steps(self, draws) -> check.Snapshot:
        r, state, d = self.runner, self.state, self.data
        r.load_epoch(draws)
        if r.cuda_graph:
            graph = r.capture(state, d.feats, d.labels)
            step = graph.replay
        else:
            def step():
                r._eager_step(state, d.feats, d.labels)
        params = dict(state.model.named_parameters())
        seen = [self.weights]
        for k in range(3):
            step()
            if k == 0:
                grad = self.first_grad(state.optimizer, params)
            seen.append(self.params_now(params))
        losses = [float(v) for v in r.batch_losses[:3].cpu()]
        for _ in range(r.n_batches - 3):
            step()
        state.step += r.n_batches
        float(r.batch_losses.mean())
        return check.trajectory(losses, grad, seen)

    def _epoch(self) -> float:
        with torch.profiler.record_function("gnnbench.run_epoch"):
            self.state, loss = self.runner.run_epoch(self.state, self.data.feats,
                                                     self.data.labels)
        with torch.profiler.record_function("gnnbench.loss_read"):
            return float(loss)

    def window(self, seconds: float) -> dict:
        epochs, bad = 0, 0
        t0 = time.perf_counter()
        while True:
            loss = self._epoch()
            epochs += 1
            bad += not np.isfinite(loss)
            if time.perf_counter() - t0 >= seconds:
                break
        s = time.perf_counter() - t0
        seeds = epochs * self.traffic.n_train
        self.win = {"seconds": s, "epochs": epochs, "batches": epochs * self.runner.n_batches,
                    "seeds": seeds}
        return {"metrics": {"train_seeds_per_s": {"value": seeds / s, "unit": "seeds/s"}},
                "attempted": self.win["batches"], "failed": bad * self.runner.n_batches}

    def traced(self) -> None:
        def slice_():
            for _ in range(TRACED_EPOCHS):
                self._epoch()

        self.traced_slice(slice_)
        self.phases = self._phase_split()

    def _phase_split(self) -> dict:
        """ms a batch of each of ``PHASES``: an epoch of replays of the step captured
        with timing events between its phases (the runner's ``capture(marks)``),
        each replay waited for so that its events can be read."""
        r, d = self.runner, self.data
        marks = [torch.cuda.Event(enable_timing=True, external=True)
                 for _ in range(len(PHASES) + 1)]
        r.load_epoch()
        graph = r.capture(self.state, d.feats, d.labels, marks)
        total = np.zeros(len(PHASES))
        for _ in range(r.n_batches):
            graph.replay()
            marks[-1].synchronize()
            total += [marks[k].elapsed_time(marks[k + 1]) for k in range(len(PHASES))]
        return dict(zip(PHASES, (total / r.n_batches).tolist()))

    def flops_per_seed(self) -> float:
        t = self.traffic
        rows = [(n, n * (1 + f), n * f)
                for (n, _), f in zip(counts.block_rows(t.batch_size, list(t.fanouts)),
                                     t.fanouts)]
        return self.ref.train_flops(self.cfg, t.n_feat, t.n_class, rows) / t.batch_size

    def free_program(self) -> None:
        self.runner = self.state = None

    def reference(self, follow=None, tf32: bool = False,
                  half_batch: bool = False) -> check.Snapshot:
        """The reference's three steps on the check's draws (``_reference_steps``);
        ``tf32``: its products in TF32 (the control); ``half_batch``: the second half
        of each batch left out of the loss (a fault)."""
        t, d = self.traffic, self.data
        order, uniforms = self.draws
        b = t.batch_size
        nb = order.numel() // b
        seeds = torch.zeros(nb * b, dtype=torch.int32, device=self.device)
        seeds[: t.n_train] = d.train_nodes.to(torch.int32)
        mask = torch.arange(nb * b, device=self.device) < t.n_train
        seeds, mask = seeds[order], mask[order]
        gen = torch.Generator(device=self.device).manual_seed(self.seeds["program"])

        def loss_of(p, k):
            sl = slice(k * b, (k + 1) * b)
            draws = [(ua[k], ul[k]) for ua, ul in uniforms]
            blocks = reference.sample_blocks(d.indptr, d.csr_src, seeds[sl], mask[sl],
                                             list(t.fanouts), draws)
            x = d.feats[blocks[0].src_ids.long()]
            y = d.labels[blocks[-1].dst_ids.long()]
            logp = self.ref.forward_blocks(self.cfg, p, blocks, x, gen)
            m = blocks[-1].dst_mask
            if half_batch:
                m = m & (torch.arange(b, device=self.device) < b // 2)
            return reference.nll(logp, y, m)

        return self._reference_steps(loss_of, tf32, follow)
