"""Full-graph GCN train step on a clustered graph.

    python -m dgll_tpu_torch.bench [--device cuda] [--layout auto|chunked]

Counterpart of the JAX package's full-graph bench (``bench.py``,
``_fullgraph_kernel_bench``): the same clustered graph, bit for bit (a stochastic
block graph from ``default_rng(1)``: communities of 2,048 nodes, 90% of edges inside
the destination's community, self-loops, ``gcn_normalize``), a 2-layer GCN of
widths 128/128/128 without dropout, Adam 1e-3, and the same chain-difference timing:
2 warm-up steps, then ``(time of 9 steps - time of 3 steps) / 6``, each chain ending
in a host read of the loss. ``BENCH_FG_NODES`` (200,000), ``BENCH_FG_DEG`` (16) and
``BENCH_FG_DTYPE`` (``float32`` or ``bfloat16``, the layers' compute type) set it.

``--layout auto`` attaches ``with_windowed()`` (K2, and K1 on the residual edges,
where the graph has the locality; the JAX bench's choice) and ``with_chunked()``;
``--layout chunked`` attaches the K1 layouts only, for comparison.

It prints one JSON line with the JAX bench's keys and a few more:

* ``kernel``: ``windowed_hybrid`` or ``classic_chunked``, whichever the GCN ran;
* ``pad_factor``: rows of the layer's input the kernels read per edge, on A and A^T
  together (K2 stages up to 128 rows per sub-chunk, K1 gathers one row per edge,
  so K1 alone gives 1.0);
* ``roofline_fraction``: those rows and the output rows written, for the 4 SpMM
  passes of a step at width 128, over ``step_ms``, as a share of
  ``roofline_gbps``, the H100 SXM's 3,350 GB/s of HBM3;
* ``losses``: every step's loss; ``launches``: the K2 and K1 launches of the run.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

HBM_GBPS = 3350.0   # H100 SXM, HBM3 (NVIDIA's data sheet)
FEAT, HIDDEN, N_CLASS = 128, 128, 128
CSIZE, LOCAL = 2048, 0.9
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def clustered_graph(n_node: int, avg_deg: int):
    """The JAX bench's clustered graph, from the same generator calls in the same
    order, with self-loops (before ``gcn_normalize``)."""
    from dgll_tpu_torch.graph import Graph

    rng = np.random.default_rng(1)
    n_edge0 = n_node * avg_deg
    dstc = rng.integers(0, n_node, n_edge0)
    loc = rng.random(n_edge0) < LOCAL
    srcc = np.where(loc, (dstc // CSIZE) * CSIZE + rng.integers(0, CSIZE, n_edge0),
                    rng.integers(0, n_node, n_edge0)) % n_node
    return Graph.from_edges(
        srcc, dstc, n_node,
        node_feat=rng.standard_normal((n_node, FEAT), dtype=np.float32),
        labels=rng.integers(0, N_CLASS, n_node).astype(np.int32),
        train_mask=np.ones(n_node, bool),
        add_self_loops=True,
    )


def rows_read(g) -> tuple:
    """Rows of the input the SpMM kernels read on A and on A^T: K2's staged rows
    plus K1's gathered residual rows, or K1's rows alone."""
    if g.hybrid is None:
        return g.chunked.src.numel(), g.chunked_t.src.numel()

    def one(h):
        res = 0 if h.res is None else h.res.src.numel()
        return int(h.win.sub_nx.sum()) + res

    return one(g.hybrid), one(g.hybrid_t)


@dataclass
class Setup:
    """A bench run ready to step: the graph with its layouts and the model's train
    state on the device, the step function and its dropout generator."""

    g: Any
    state: Any
    step: Callable
    gen: torch.Generator
    dtype_name: str
    preprocess_s: float

    def run(self, k: int, losses: list) -> None:
        """``k`` train steps, their losses appended to ``losses``; no host sync."""
        for _ in range(k):
            self.state, loss = self.step(self.state, self.g, self.g.node_feat,
                                         self.g.labels, self.g.train_mask, self.gen)
            losses.append(loss)


def setup(device: str = "cuda", layout: str = "auto") -> Setup:
    """Build the graph (``BENCH_FG_NODES``, ``BENCH_FG_DEG``), its layouts, the
    model (``BENCH_FG_DTYPE``) and its optimizer on ``device``."""
    from dgll_tpu_torch.data import gcn_normalize
    from dgll_tpu_torch.nn import GCN
    from dgll_tpu_torch.run import resolve_device
    from dgll_tpu_torch.train import create_train_state, make_full_batch_step

    if layout not in ("auto", "chunked"):
        raise ValueError(f"unknown layout {layout!r}")
    n_node = int(os.environ.get("BENCH_FG_NODES", 200_000))
    avg_deg = int(os.environ.get("BENCH_FG_DEG", 16))
    dtype_name = os.environ.get("BENCH_FG_DTYPE", "float32")
    dtype = DTYPES[dtype_name]
    dev = resolve_device(device)

    t0 = time.perf_counter()
    g = gcn_normalize(clustered_graph(n_node, avg_deg))
    if layout == "auto":
        g = g.with_windowed()
    g = g.with_chunked()
    preprocess_s = time.perf_counter() - t0
    g = g.to(dev)
    model = GCN(FEAT, hidden=HIDDEN, n_class=N_CLASS, dropout=0.0,
                dtype=None if dtype == torch.float32 else dtype,
                generator=torch.Generator().manual_seed(0)).to(dev)
    state = create_train_state(model, functools.partial(torch.optim.Adam, lr=1e-3))
    return Setup(g, state, make_full_batch_step(), torch.Generator(device=dev).manual_seed(1),
                 dtype_name, preprocess_s)


def fullgraph_step(device: str = "cuda", layout: str = "auto") -> dict:
    """Build, train for 14 steps and time the step; returns the result dict."""
    from dgll_tpu_torch.ops.cuda import segment_matmul as sm
    from dgll_tpu_torch.ops.cuda import spmm_windowed as sw

    b = setup(device, layout)
    g = b.g
    windowed = g.hybrid is not None
    losses: list = []

    def run_chain(k: int) -> float:
        t1 = time.perf_counter()
        b.run(k, losses)
        float(losses[-1])
        return time.perf_counter() - t1

    sw.launches_fwd = sw.launches_bwd = sm.launches_fwd = sm.launches_bwd = 0
    run_chain(2)
    t_small = run_chain(3)
    t_large = run_chain(9)
    dt = max((t_large - t_small) / 6, 1e-9)

    n_node, n_edge = g.n_node, g.n_real_edge
    read_a, read_at = rows_read(g)
    itemsize = torch.empty((), dtype=DTYPES[b.dtype_name]).element_size()
    bytes_moved = 2 * (read_a + read_at + 2 * n_node) * HIDDEN * itemsize
    dev = g.src.device
    out = {
        "dtype": b.dtype_name,
        "kernel": "windowed_hybrid" if windowed else "classic_chunked",
        "step_ms": dt * 1e3,
        "edges_per_s_per_layerpass": int(4 * n_edge / dt),
        "n_node": n_node,
        "n_edge": int(n_edge),
        "windowed_fraction": g.hybrid.windowed_fraction if windowed else 0.0,
        "pad_factor": (read_a + read_at) / (2 * n_edge),
        "roofline_fraction": bytes_moved / dt / 1e9 / HBM_GBPS,
        "roofline_gbps": HBM_GBPS,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "layout_preprocess_s": b.preprocess_s,
        "steps": len(losses),
        "losses": [float(x) for x in losses],
        "launches": {"k2_fwd": sw.launches_fwd, "k2_bwd": sw.launches_bwd,
                     "k1_fwd": sm.launches_fwd, "k1_bwd": sm.launches_bwd},
    }
    if windowed:
        out["windowed_fraction_t"] = g.hybrid_t.windowed_fraction
        out["sub_chunks"] = [g.hybrid.win.n_sub, g.hybrid_t.win.n_sub]
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--layout", default="auto", choices=("auto", "chunked"),
                   help="auto: windowed where the graph has locality; chunked: K1 only")
    args = p.parse_args(argv)
    out = fullgraph_step(args.device, args.layout)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
