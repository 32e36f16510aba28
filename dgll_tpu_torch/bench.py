"""The port's benchmarks: the headline minibatch bench and the full-graph GCN step.

    python -m dgll_tpu_torch.bench [--device cuda] [--layout auto|chunked]

Counterpart of the JAX package's ``bench.py``. **Headline** (``main``): the end-to-end
training batch time, sampling included (``sage_batch_time_incl_sampling``), of
minibatch GraphSAGE at ogbn-products scale, the reference's flagship workload: the
JAX bench's power-law graph, bit for bit (``power_law_graph``: 2.4M nodes of average
in-degree 25 drawn by inverse CDF from ``default_rng(0)``, the CSR by
``native.build_csr_apply``), 100 features, 48 classes and 8% train nodes from
``default_rng(0)`` in the JAX bench's order, a 2-layer GraphSAGE of hidden width 256
without dropout, Adam 1e-3, fanouts [15, 10] and batches of 1024. The CSR, features
and labels live on the device; each batch samples on the device and runs as one
CUDA-graph replay (``DeviceEpochRunner``). One warm-up epoch (the capture), then two
timed epochs on the host clock, each ending in a read of the loss; ``value`` is the
last epoch's ms a batch, ``vs_baseline`` 6.12 ms (the reference's published 1-GPU
batch time, sampling included) over it. Knobs, as in the JAX bench: ``BENCH_NODES``,
``BENCH_DEG``, ``BENCH_BATCH``, ``BENCH_WINDOW`` (1, the default: block-window draws;
0: per-slot), ``BENCH_STEPONLY=0`` (skip ``step_only_ms``, the eager step of
``MiniBatchTrainer`` on host-sampled blocks), ``BENCH_FULLGRAPH=0`` (skip
``fullgraph_gcn_pallas``, the full-graph step below).

**Full-graph GCN step** (``fullgraph_step``, the JAX bench's
``_fullgraph_kernel_bench``): the same clustered graph, bit for bit (a stochastic
block graph from ``default_rng(1)``: communities of 2,048 nodes, 90% of edges inside
the destination's community, self-loops, ``gcn_normalize``), a 2-layer GCN of
widths 128/128/128 without dropout, Adam 1e-3, and the same chain-difference timing:
2 warm-up steps, then ``(time of 9 steps - time of 3 steps) / 6``, each chain ending
in a host read of the loss. ``BENCH_FG_NODES`` (200,000), ``BENCH_FG_DEG`` (16) and
``BENCH_FG_DTYPE`` (``float32`` or ``bfloat16``, the layers' compute type) set it.
``--layout auto`` attaches ``with_windowed()`` (K2, and K1 on the residual edges,
where the graph has the locality; the JAX bench's choice) and ``with_chunked()``;
``--layout chunked`` attaches the K1 layouts only, for comparison. Its dict has the
JAX bench's keys and a few more:

* ``kernel``: ``windowed_hybrid`` or ``classic_chunked``, whichever the GCN ran;
* ``pad_factor``: rows of the layer's input the kernels read per edge, on A and A^T
  together (K2 stages up to 128 rows per sub-chunk, K1 gathers one row per edge,
  so K1 alone gives 1.0);
* ``roofline_fraction``: those rows and the output rows written, for the 4 SpMM
  passes of a step at width 128, over ``step_ms``, as a share of
  ``roofline_gbps``, the H100 SXM's 3,350 GB/s of HBM3;
* ``losses``: every step's loss; ``launches``: the K2 and K1 launches of the run.

``main`` prints one JSON line with the JAX bench's keys.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

HBM_GBPS = 3350.0   # H100 SXM, HBM3 (NVIDIA's data sheet)
BASELINE_MS = 6.12  # the reference's MQ-FastGCN+f+d ogbn-products batch time, 1 GPU
# the headline's model and sample (the JAX bench's)
SAGE_FEAT, SAGE_CLASSES, SAGE_HIDDEN = 100, 48, 256
FANOUTS = [15, 10]
TRAIN_FRAC = 0.08  # products-like split
SEED = 0  # the headline's weights and draws
TIMED_EPOCHS = 2  # after one warm-up epoch
# the layer-wise samplers' configuration (benchmarks/epoch_bench.py:195-271): layer
# sizes outermost first, and the ELL width of the device Laplacian
LAYERWISE_SIZES = [2048, 1024]
ELL_K = 32
# the full-graph step's widths
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


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def power_law_graph(n_node: int, avg_deg: int):
    """The JAX bench's Zipf-like COO ``(src, dst)``, from the same generator calls:
    destinations by inverse CDF of ``(v + 1) ** -0.9``, sources uniform."""
    rng = np.random.default_rng(0)
    n_edge = n_node * avg_deg
    w = (np.arange(n_node, dtype=np.float64) + 1.0) ** -0.9
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    dst = np.searchsorted(cdf, rng.random(n_edge)).astype(np.int64)
    src = rng.integers(0, n_node, n_edge)
    return src, dst


@dataclass
class Flagship:
    """The headline's data: the host CSR, its device copy, the features, labels and
    train nodes (``flagship_data``)."""

    n_node: int
    avg_deg: int
    indptr: np.ndarray
    src: np.ndarray
    csr: Any
    feats: torch.Tensor
    labels: torch.Tensor
    train_nodes: np.ndarray


def flagship_data(device="cuda") -> Flagship:
    """The headline's graph (``BENCH_NODES``, ``BENCH_DEG``) and its features, labels
    and train nodes, in the JAX bench's order, on ``device``."""
    from dgll_tpu_torch import native
    from dgll_tpu_torch.sampling import DeviceCSR

    n_node = int(os.environ.get("BENCH_NODES", 2_400_000))
    avg_deg = int(os.environ.get("BENCH_DEG", 25))
    t0 = time.perf_counter()
    src, dst = power_law_graph(n_node, avg_deg)
    _log(f"graph gen {time.perf_counter() - t0:.1f}s ({n_node} nodes, {len(src)} edges)")
    fused = native.build_csr_apply(dst, src, None, n_node)
    if fused is not None:
        indptr, src_s, _, _ = fused
    else:  # no host toolchain: the numpy CSR build
        order = np.argsort(dst, kind="stable")
        src_s = src[order].astype(np.int32)
        indptr = np.zeros(n_node + 1, np.int64)
        np.add.at(indptr, dst + 1, 1)
        indptr = np.cumsum(indptr)
    _log(f"csr built {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    dev = torch.device(device)
    feats = torch.from_numpy(rng.standard_normal((n_node, SAGE_FEAT),
                                                 dtype=np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, SAGE_CLASSES, n_node).astype(np.int32)).to(dev)
    train_nodes = rng.choice(n_node, int(TRAIN_FRAC * n_node), replace=False)
    csr = DeviceCSR.from_host_arrays(indptr, src_s, dev)
    _log(f"features on device {time.perf_counter() - t0:.1f}s")
    return Flagship(n_node, avg_deg, indptr, src_s, csr, feats, labels, train_nodes)


def flagship_runner(data: Flagship, batch: int, window: bool,
                    adam: Optional[dict] = None, cuda_graph: Optional[bool] = None,
                    dropout: float = 0.0, train_nodes=None):
    """``(runner, state)``: the headline's GraphSAGE (weights and draws from ``SEED``)
    and its ``DeviceEpochRunner`` on ``data``. ``adam``: Adam's options (default
    ``GRAPH_ADAM`` on a CUDA device, none on the CPU); ``train_nodes`` replaces the
    data's."""
    from dgll_tpu_torch.nn import GraphSAGE
    from dgll_tpu_torch.train import GRAPH_ADAM, DeviceEpochRunner

    dev = data.csr.device
    if adam is None:
        adam = GRAPH_ADAM if dev.type == "cuda" else {}
    model = GraphSAGE(SAGE_FEAT, SAGE_HIDDEN, SAGE_CLASSES, dropout=dropout,
                      generator=torch.Generator().manual_seed(SEED))
    runner = DeviceEpochRunner(
        model, functools.partial(torch.optim.Adam, lr=1e-3, **adam), data.csr, FANOUTS,
        batch, data.train_nodes if train_nodes is None else train_nodes, seed=SEED,
        window=window, cuda_graph=cuda_graph)
    return runner, runner.init_state(data.feats)


def layerwise_lap(data: Flagship, k: int = ELL_K):
    """The flagship graph's normalised Laplacian in the device ELL layout
    (``build_device_lap`` over a ``Graph`` view of its CSR), on the CSR's device."""
    from dgll_tpu_torch.graph import Graph
    from dgll_tpu_torch.sampling import build_device_lap

    n_edge = len(data.src)
    dst = np.repeat(np.arange(data.n_node, dtype=np.int32), np.diff(data.indptr))
    g = Graph(indptr=torch.from_numpy(data.indptr.astype(np.int32)),
              src=torch.from_numpy(data.src.astype(np.int32)), dst=torch.from_numpy(dst),
              n_node=data.n_node, n_edge=n_edge, n_real_node=data.n_node,
              n_real_edge=n_edge)
    return build_device_lap(g, k, device=data.csr.device)


def layerwise_runner(data: Flagship, lap, mode: str, cuda_graph: Optional[bool] = None,
                     dropout: float = 0.0, train_nodes=None):
    """``(runner, state)``: the layer-wise configuration of the JAX package's
    ``benchmarks/epoch_bench.py:195-271`` on the flagship's data: a 2-layer GCN of
    hidden width 256 (weights from ``SEED``), Adam 1e-3 (capturable on a CUDA
    device), FastGCN or LADIES (``mode``) with layer sizes ``LAYERWISE_SIZES`` over
    ``lap`` (``layerwise_lap``), batches of 1,024."""
    from dgll_tpu_torch.nn import GCN
    from dgll_tpu_torch.train import GRAPH_ADAM, DeviceEpochRunner

    adam = GRAPH_ADAM if lap.device.type == "cuda" else {}
    model = GCN(SAGE_FEAT, SAGE_HIDDEN, SAGE_CLASSES, dropout=dropout,
                generator=torch.Generator().manual_seed(SEED))
    runner = DeviceEpochRunner(
        model, functools.partial(torch.optim.Adam, lr=1e-3, **adam), lap,
        LAYERWISE_SIZES, 1024, data.train_nodes if train_nodes is None else train_nodes,
        seed=SEED, sampler=mode, cuda_graph=cuda_graph)
    return runner, runner.init_state(data.feats)


def time_epochs(runner, state, data: Flagship) -> list:
    """ms a batch of each of ``TIMED_EPOCHS`` epochs on the host clock, each ending in
    a read of its loss (the JAX bench's timing), after a warm-up epoch."""
    loss = float(runner.run_epoch(state, data.feats, data.labels)[1])
    _log(f"device pipeline ready (warm-up loss {loss:.4f})")
    out = []
    for _ in range(TIMED_EPOCHS):
        t1 = time.perf_counter()
        _, loss = runner.run_epoch(state, data.feats, data.labels)
        loss = float(loss)
        out.append((time.perf_counter() - t1) * 1e3 / runner.n_batches)
        _log(f"epoch {out[-1] * runner.n_batches:.1f} ms ({out[-1]:.4f} ms/batch) "
             f"loss={loss:.4f}")
    return out


def step_only_ms(data: Flagship, batch: int, dev: torch.device) -> float:
    """The JAX bench's ``_step_only_bench``: the eager train step of
    ``MiniBatchTrainer`` on 8 blocks presampled on the host, ms a step from the
    difference of chains of 30 and 10 steps."""
    from dgll_tpu_torch.nn import GraphSAGE
    from dgll_tpu_torch.sampling import HostGraph, NeighborSampler
    from dgll_tpu_torch.train import MiniBatchTrainer

    hg = HostGraph(data.indptr, data.src, data.n_node)
    rng = np.random.default_rng(1)
    sampler = NeighborSampler(FANOUTS, seed=0)
    tr = MiniBatchTrainer(GraphSAGE(SAGE_FEAT, SAGE_HIDDEN, SAGE_CLASSES, dropout=0.0,
                                    generator=torch.Generator().manual_seed(0)),
                          functools.partial(torch.optim.Adam, lr=1e-3), device=dev)
    pool = []
    for _ in range(8):
        _, _, blocks = sampler.sample(hg, rng.integers(0, data.n_node, batch), pad_to=batch)
        pool.append(tr.batch_inputs(blocks, data.feats, data.labels))
    state = tr.init_state()

    def run_chain(k: int) -> float:
        nonlocal state
        t1 = time.perf_counter()
        loss = None
        for i in range(k):
            state, loss = tr.step(state, *pool[i % len(pool)], tr.generator)
        float(loss)
        return time.perf_counter() - t1

    run_chain(3)  # the JAX bench's first step and its chain of 2
    t_small = run_chain(10)
    t_large = run_chain(30)
    return max((t_large - t_small) / 20, 1e-9) * 1e3


def main(argv=None, data: Optional[Flagship] = None) -> dict:
    """Run the headline and print its JSON line. ``data``: the flagship's data, where
    a caller has built it already (``flagship_data``; its graph takes about 20 s)."""
    from dgll_tpu_torch.run import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--layout", default="auto", choices=("auto", "chunked"),
                   help="the full-graph step's layouts: auto, windowed where the graph "
                        "has locality; chunked, K1 only")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    batch = int(os.environ.get("BENCH_BATCH", 1024))
    window = os.environ.get("BENCH_WINDOW", "1") == "1"

    data = flagship_data(dev) if data is None else data
    runner, state = flagship_runner(data, batch, window)
    batch_ms = time_epochs(runner, state, data)[-1]
    # edges aggregated per batch across both layers
    edges_per_batch = batch * FANOUTS[-1] + batch * (1 + FANOUTS[-1]) * FANOUTS[0]
    detail = {
        "includes_sampling": True,
        "sampling": "device block-window" if window else "device per-slot",
        "n_batches_per_epoch": runner.n_batches,
        "edges_per_s": int(edges_per_batch / (batch_ms / 1e3)),
        "n_node": data.n_node,
        "avg_deg": data.avg_deg,
        "batch": batch,
        "fanouts": FANOUTS,
        "feat_dim": SAGE_FEAT,
        "hidden": SAGE_HIDDEN,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "cuda_graph": runner.cuda_graph,
        "adam": {k: v for k, v in state.optimizer.defaults.items()
                 if k in ("capturable", "fused", "foreach")},
    }
    if os.environ.get("BENCH_STEPONLY", "1") != "0":
        detail["step_only_ms"] = step_only_ms(data, batch, dev)
        _log(f"step-only: {detail['step_only_ms']} ms")
    del runner, state, data
    if os.environ.get("BENCH_FULLGRAPH", "1") != "0":
        detail["fullgraph_gcn_pallas"] = fullgraph_step(args.device, args.layout)
        _log(f"fullgraph kernel bench: {detail['fullgraph_gcn_pallas']}")
    out = {
        "metric": "sage_batch_time_incl_sampling",
        "value": batch_ms,
        "unit": "ms",
        "vs_baseline": BASELINE_MS / batch_ms,
        "detail": detail,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
