"""Training modes: one driver a ``mode`` of the traffic files (``minibatch``, ``full``).

A driver's ``Run`` has the cell's configuration, traffic, seeds and device, and:
``setup()`` builds the port's training object and drives its first steps for the
check (``self.prog``), then warms the window's path up; ``window(seconds)`` runs the
timed work and returns the end-to-end metrics; ``traced()`` runs a bounded slice
under the profiler (and, where the port has them, its phase events) for the
per-layer metrics; ``free_program()`` drops the port's state; ``reference(follow=...)``
gives the plain reference's ``check.Snapshot`` of the same three steps, each from the
program's parameters before it (without ``follow``: chained, for the control and the
faults).
"""
from __future__ import annotations

import importlib
import sys
import time
from typing import Callable, Optional

import torch

from gnnbench import check, reference, weights


class Base:
    def __init__(self, cfg: dict, traffic, seeds: dict, device: torch.device):
        self.cfg, self.traffic, self.seeds, self.device = cfg, traffic, seeds, device
        self._mark = time.perf_counter()
        self.port = importlib.import_module(f"gnnbench.arch.{cfg['arch']}")
        self.ref = importlib.import_module(f"gnnbench.reference.{cfg['arch']}")
        reference.refuse_unbuilt(cfg, self.ref.READS, self.ref.FIXED)
        self.weights = weights.make(
            self.ref.specs(cfg, traffic.n_feat, traffic.n_class), seeds["weights"], device)
        self.layout_build_s: Optional[float] = None
        self.trace = None
        self.phases: Optional[dict] = None
        self.win: dict = {}

    def mark(self, what: str) -> None:
        """Log the set-up's progress: seconds since the last mark, on stderr."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        now, last = time.perf_counter(), self._mark
        self._mark = now
        print(f"[gnnbench] {what}: {now - last:.3f} s", file=sys.stderr, flush=True)

    def traced_slice(self, fn: Callable[[], None]) -> None:
        """``fn`` (a few epochs) under the profiler, with the port's launch counters'
        increments over it."""
        from gnnbench import trace

        before = launch_counts()
        self.trace = trace.traced(fn)
        after = launch_counts()
        self.trace.counters = {f: {k: n - before[f][k] for k, n in c.items()}
                               for f, c in after.items()}
        self.trace.check_port()

    @staticmethod
    def first_grad(opt, params: dict) -> dict:
        """The gradient as the optimizer got it at its first step, from its state:
        Adam's first moment over ``1 - beta1`` (zero where it holds none)."""
        beta1 = opt.param_groups[0]["betas"][0]
        return {k: opt.state[p]["exp_avg"].detach().clone() / (1 - beta1)
                if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p)
                for k, p in params.items()}

    def params_now(self, params: dict) -> dict:
        return {k: p.detach().clone() for k, p in params.items()}

    def _reference_steps(self, loss_of: Callable, tf32: bool,
                         follow: Optional[check.Snapshot]) -> check.Snapshot:
        """Three steps of the reference; ``loss_of(params, k)`` is step ``k``'s loss
        (each call draws that step's dropout masks), Adam or AdamW as the
        configuration states. ``follow``: a program's snapshot, whose parameters
        before each step the reference starts that step from; without it the
        reference chains its own steps from the benchmark's weights and returns a
        program's snapshot of them (the control and the faults)."""
        cfg = self.cfg
        opt = reference.Adam(cfg["lr"], cfg["weight_decay"],
                             decoupled=bool(cfg["weight_decay"]))
        cur = {k: v.clone() for k, v in self.weights.items()}
        losses, grad, params, moves = [], None, [cur], []
        prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
        try:
            for k in range(3):
                start = cur if follow is None else follow.starts[k]
                p = {n: v.clone().requires_grad_(True) for n, v in start.items()}
                loss = loss_of(p, k)
                g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
                losses.append(float(loss.detach()))
                if grad is None:
                    grad = {n: v.detach().clone() for n, v in g.items()}
                p = {n: v.detach() for n, v in p.items()}
                opt.step(p, g)
                moves.append({n: p[n] - start[n] for n in p})
                cur = p
                params.append(cur)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        if follow is None:
            return check.trajectory(losses, grad, params)
        return check.Snapshot(losses, grad, moves)


def launch_counts() -> dict:
    """The port's kernel launch counters by the family of kernels they count (the
    families of ``trace.PORT``): ``{family: {counter: launches}}``. ``gat_csr``'s
    ``gat_stats`` counts K3, and so on."""
    from dgll_tpu_torch.ops.cuda import edge_ops, gat_fused, probes, quantize
    from dgll_tpu_torch.ops.cuda import segment_matmul as k1
    from dgll_tpu_torch.ops.cuda import spmm_windowed as k2

    return {"segment_matmul": {"k1": k1.launches_fwd + k1.launches_bwd},
            "spmm_windowed": {"k2": k2.launches_fwd + k2.launches_bwd},
            "gat_csr": {**gat_fused.launches,
                        **{f"edge_ops.{k}": n for k, n in edge_ops.launches.items()}},
            "quantize": {"quantize": quantize.launches},
            "probes": dict(probes.launches)}


def driver(mode: str):
    return importlib.import_module(f"gnnbench.modes.{mode}").Run
