"""Where the time of a full-batch slice goes on a CUDA device.

    python -m dgll_tpu_torch.tools.profile_slice [--gat | --clustered | --small |
                                                  --device_sampling | --host_packed]
                                                 [--dtype float32|bfloat16]
                                                 [--sampler neighbor|fastgcn|ladies]

It takes a slice that ``chip_smoke.py`` trains, on a 200k-node power-law graph with
16 classes: a 2-layer GCN of width 128 (``SLICE_ARGS``), or with ``--gat`` the
2-layer GAT of 8 heads x 8 features (``GAT_SLICE_ARGS``), and measures:

* a ``torch.profiler`` trace of ``STEPS`` epochs of ``FullBatchTrainer.fit``,
  without and with the per-epoch validation pass the CLI runs: host wall time,
  device busy time (the sum of the traced kernel, copy and fill times, which run on
  one stream), the device's idle share of the wall time, and each kernel's share of
  the busy time;
* the hub-row probe (CUDA events, median of 15) on the layout of A, on only its
  rows with more than ``HUB`` in-edges, and with every row cut to its first ``CAP``
  edges: the SpMM kernel at each width of the model and, for GAT, the row
  reductions K3, K5 and K6 (sum and max) at the hidden layer's head count;
* for GAT, K3 and K5 on copies of the layout of A whose long rows are cut at each
  split threshold of ``SPLIT_SWEEP`` (``split_sweep``), at the hidden layer's head
  count and at one head.

``--gat --dtype bfloat16`` trains the GAT slice in bfloat16 (the CLI's ``--dtype``)
and profiles only its epochs: the hub probe and the split sweep time float32
kernels, and ``--small`` splits K1's bfloat16 calls.

With ``--clustered`` it profiles the full-graph bench's GCN step instead
(``dgll_tpu_torch.bench``, 200k-node clustered graph, widths 128): ``STEPS`` train
steps through the windowed layout (K2 and K1 on the residual edges) and through K1
alone, without the hub-row probe (the graph has no hubs).

With ``--device_sampling`` it profiles the headline bench's flagship
(``dgll_tpu_torch.bench``: minibatch GraphSAGE with device sampling at its sizes,
``BENCH_NODES`` and ``BENCH_WINDOW`` as the bench reads them): one epoch replayed as
a CUDA graph a batch under ``torch.profiler`` (wall, device busy, idle share, the
kernels' shares), and the batch's device time split into its phases (sampling, the
feature and label gather, forward with the loss, backward, the optimizer step) by
CUDA events captured inside a graph of the same step, summed over an epoch of
replays (``phase_split``). ``--sampler fastgcn`` or ``ladies`` profiles the
layer-wise configuration on the same data instead (``bench.layerwise_runner``: GCN of
hidden width 256, layer sizes [2048, 1024], the device Laplacian of ELL width 32,
whose build time it prints).

With ``--host_packed`` it profiles the packed host pipeline at the same sizes (the
configuration of ``benchmarks/epoch_bench.py:335-411``: the bench's graph sampled on
the host by two producer threads, ``DataLoader(packed=True, prefetch=4)``, each batch's
``(ids, mask)`` copied to the card and ``MiniBatchTrainer.run_epoch_packed``'s step
replayed as a CUDA graph): one epoch under ``torch.profiler`` after a warm-up epoch
(wall, device busy, idle share, the kernels' shares).

With ``--small`` it splits the time of each kernel under 0.15 ms at the slices'
shapes (and of K4 at 8 heads beside its one head), of K1 on the bfloat16 GAT's
messages (identity columns on A and ``t_slot_perm`` columns on A^T, widths 16 and
64), and of the library calls beside them, into the device time of the kernels it
launches and the host time of its wrapper (``small_kernels``): at a few tens of
microseconds the wrapper's host work before the launch is part of what a CUDA-event
timing of one call reads.

Each result is a line; the last line is one JSON object with every number.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from dgll_tpu_torch.ops.chunked import ChunkedCSR, build_chunked
from dgll_tpu_torch.utils.profiling import cuda_median_ms

# The slices' CLI arguments (dgll_tpu_torch.run), without the epoch count: GCN, and
# the published GAT (8 heads x 8 features, dropout 0.6, Adam with weight decay) on
# the same graph.
SLICE_ARGS = ["--Model", "GCN", "--samp_type", "full", "--n_node", "200000",
              "--avg_degree", "16", "--feat_dim", "128", "--nhid", "128",
              "--n_class", "16", "--n_stops", "0", "--device", "cuda"]
GAT_SLICE_ARGS = ["--Model", "GAT", "--samp_type", "full", "--n_node", "200000",
                  "--avg_degree", "16", "--feat_dim", "128", "--nhid", "8",
                  "--n_heads", "8", "--dropout", "0.6", "--lr", "0.005",
                  "--weight_decay", "0.0005", "--n_class", "16", "--n_stops", "0",
                  "--device", "cuda"]
STEPS = 5     # profiled epochs
HUB = 4096    # a row with more in-edges than this is a hub
CAP = 1024    # edges kept per row in the probe's capped layout
# split thresholds at which --gat times K3 and K5 (the layouts' own is SPLIT_EDGES)
SPLIT_SWEEP = (128, 256, 512, 1024, 2048, 4096)
SMALL_REPS = 50  # calls a --small measurement averages


def restrict_rows(c: ChunkedCSR, keep_row: Optional[np.ndarray] = None,
                  cap: Optional[int] = None) -> ChunkedCSR:
    """Layout ``c`` with only the rows where ``keep_row`` holds, each cut to its
    first ``cap`` edges (in the layout's order), on ``c``'s device."""
    indptr = c.indptr.cpu().numpy().astype(np.int64)
    rows = c.rows.cpu().numpy().astype(np.int64)
    keep = np.ones(len(rows), bool)
    if keep_row is not None:
        keep &= keep_row[rows]
    if cap is not None:
        keep &= np.arange(len(rows)) - indptr[rows] < cap
    sub = build_chunked(c.src.cpu().numpy()[keep], rows[keep], c.n_rows, c.n_cols,
                        c.weight.cpu().numpy()[keep])
    return sub.to(c.src.device)


def _traced(fn):
    """Run ``fn()`` under ``torch.profiler``: (host wall ms, {kernel name cut to 90
    characters: {"ms", "count"}}), kernels that share a cut name added up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            k = kernels.setdefault(e.key[:90], {"ms": 0.0, "count": 0})
            k["ms"] += e.self_device_time_total / 1e3
            k["count"] += e.count
    return wall_ms, kernels


# the names of K1's kernels (csrc/segment_matmul.cu): pass 1 of either route, pass 2
K1_KERNELS = ("::spmm_csr_kernel<", "::spmm_bf16_kernel<", "::combine_kernel<")


def profile(fn) -> dict:
    """Trace ``fn()`` and split its host wall time into device busy and idle; ``k1``
    sums K1's kernels (both passes), which the top 8 may leave out."""
    wall_ms, kernels = _traced(fn)
    busy_ms = sum(k["ms"] for k in kernels.values())
    if busy_ms <= 0:
        raise RuntimeError("the profiler traced no device time")
    for k in kernels.values():
        k["share"] = k["ms"] / busy_ms
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:8])
    k1 = [v for name, v in kernels.items() if any(n in name for n in K1_KERNELS)]
    k1_ms = sum(v["ms"] for v in k1)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "kernels": top, "k1": {"ms": k1_ms, "share": k1_ms / busy_ms,
                                   "count": sum(v["count"] for v in k1)}}


def profile_training(cfg, steps: int):
    """Profiles of ``steps`` epochs of training, with the graph (its kernel layout
    attached, on the device) and the class count they ran with."""
    from dgll_tpu_torch.run import build_dataset, build_model, make_optimizer, resolve_device
    from dgll_tpu_torch.train import FullBatchTrainer

    dev = resolve_device(cfg.device)
    g = build_dataset(cfg).with_chunked().to(dev)
    n_class = int(g.labels[: g.n_real_node].max()) + 1
    model = build_model(cfg, n_class, g.node_feat.shape[1],
                        generator=torch.Generator().manual_seed(cfg.seed))
    tr = FullBatchTrainer(model, make_optimizer(cfg), seed=cfg.seed, device=dev)
    fit = functools.partial(tr.fit, g, g.node_feat, g.labels, g.train_mask)
    fit(epochs=2)  # warm-up: cuBLAS handles, the allocator, the kernel library
    return {
        "steps": steps,
        "train_only": profile(lambda: fit(epochs=steps)),
        "with_validation": profile(lambda: fit(g.val_mask, epochs=steps)),
    }, g, n_class


def _row_reductions(lay: ChunkedCSR, heads: int, gen) -> dict:
    """Calls of the GAT row-reduction kernels K3, K5, K6 (sum, max) on ``lay``."""
    from dgll_tpu_torch.ops.cuda import edge_ops as tk
    from dgll_tpu_torch.ops.cuda import gat_fused as gf

    nnz, dev = lay.src.numel(), lay.src.device
    e, r = (torch.randn(nnz, heads, generator=gen, device=dev) for _ in range(2))
    rows = torch.randn(lay.n_rows, heads, generator=gen, device=dev)
    return {"K3": lambda: gf.gat_stats_cuda(lay, e, rows),
            "K5": lambda: gf.gat_bwd_softmax_cuda(lay, e, r, e, rows),
            "K6": lambda: gf.edges_to_rows_sum_cuda(lay, e),
            "K6 max": lambda: tk.edges_to_rows_max_cuda(lay, e)}


def with_split(c: ChunkedCSR, max_edges: int) -> ChunkedCSR:
    """A copy of layout ``c`` whose split schedule cuts rows at ``max_edges``."""
    from dgll_tpu_torch.ops.chunked import split_schedule

    lay = dataclasses.replace(c)
    lay.split = split_schedule(lay.indptr, max_edges)
    return lay


def split_sweep(c: ChunkedCSR, heads_list, thresholds=SPLIT_SWEEP) -> dict:
    """K3 and K5 (CUDA events, median of 15) on copies of layout ``c`` whose rows
    are cut at each threshold of ``thresholds``, at each head count of
    ``heads_list``. Every run is held against the first of its head count on the
    same inputs: m exactly equal, the rest within 1e-4 x max|ref|."""
    out = {}
    for heads in heads_list:
        first = None
        for t in thresholds:
            lay = with_split(c, t)
            fns = _row_reductions(lay, heads,
                                  torch.Generator(device=c.src.device).manual_seed(heads))
            got = fns["K3"]() + fns["K5"]()
            if first is None:
                first = got
            if not torch.equal(got[0], first[0]) or any(
                    (a - b).abs().max() > 1e-4 * b.abs().max()
                    for a, b in zip(got[1:], first[1:])):
                raise RuntimeError(f"K3/K5 at H={heads} T={t} disagree with "
                                   f"T={thresholds[0]}")
            out[f"H={heads} T={t}"] = {
                **{f"{k} ms": cuda_median_ms(fns[k]) for k in ("K3", "K5")},
                "segments": lay.split.n_seg, "split_rows": lay.split.n_split}
    return out


def hub_probe(c: ChunkedCSR, widths, hub: int, cap: int, heads: int = 0) -> dict:
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_csr_cuda

    degree = np.diff(c.indptr.cpu().numpy().astype(np.int64))
    layouts = {
        "all rows": c,
        f"rows with more than {hub} edges": restrict_rows(c, keep_row=degree > hub),
        f"every row cut to {cap} edges": restrict_rows(c, cap=cap),
    }
    gen = torch.Generator(device=c.src.device).manual_seed(0)
    out = {"hub_rows": int((degree > hub).sum()), "max_degree": int(degree.max()),
           "layouts": {}}
    for name, lay in layouts.items():
        entry = {"edges": int(lay.src.numel())}
        for f in widths:
            x = torch.randn(lay.n_cols, f, generator=gen, device=c.src.device)
            entry[f"F={f} ms"] = cuda_median_ms(lambda: spmm_csr_cuda(lay, x))
        if heads:
            for k, fn in _row_reductions(lay, heads, gen).items():
                entry[f"{k} H={heads} ms"] = cuda_median_ms(fn)
        out["layouts"][name] = entry
    return out


def wrapper_split(fn, reps: int = SMALL_REPS) -> dict:
    """One call ``fn()`` three ways, in ms a call: ``events_ms``, CUDA events around
    the call (``cuda_median_ms``, as ``chip_smoke.py`` times a kernel: the wrapper's
    host work before the launch counts, as the card idles meanwhile); ``device_ms``,
    the device time of what it launches (``torch.profiler``, ``kernels`` a call),
    over ``reps`` calls; ``host_ms``, the host time of a call, ``reps`` calls on the
    host clock with no synchronisation between them."""
    events_ms = cuda_median_ms(fn)
    _, kernels = _traced(lambda: [fn() for _ in range(reps)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return {"events_ms": events_ms,
            "device_ms": sum(k["ms"] for k in kernels.values()) / reps,
            "host_ms": host_ms,
            "kernels": sum(k["count"] for k in kernels.values()) / reps}


def bf16_sparse_mm(lay: ChunkedCSR, cols: torch.Tensor, msg: torch.Tensor):
    """``torch.sparse.mm`` of a bfloat16 CSR with ``lay``'s rows, the columns ``cols``
    and unit values, by the bfloat16 messages ``msg``: the library call that computes
    K1's unit-weight sum of per-edge messages; None where this torch has none."""
    ones = torch.ones(cols.numel(), dtype=torch.bfloat16, device=msg.device)
    mat = torch.sparse_csr_tensor(lay.indptr, cols, ones, size=(lay.n_rows, msg.shape[0]),
                                  check_invariants=False)
    try:
        torch.sparse.mm(mat, msg)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError):
        return None
    return lambda: torch.sparse.mm(mat, msg)


def k1_bf16_calls(c: ChunkedCSR, ct: ChunkedCSR, gen, widths=(16, 64)) -> dict:
    """The bfloat16 GAT's K1 calls at each width of ``widths``, as its fused op makes
    them (``spmm_edges``: identity columns on A, the forward; ``t_slot_perm`` columns
    on A^T, the backward scatter), each followed by ``bf16_sparse_mm`` of the same
    sum where this torch has it."""
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_edges

    calls = {}
    for f in widths:
        msg = torch.randn(c.src.numel(), f, generator=gen, device=c.src.device).to(
            torch.bfloat16)
        for name, lay, cols, fn in (
                ("identity columns on A", c, c.edge_ids, lambda m=msg: spmm_edges(c, m)),
                ("t_slot_perm columns on A^T", ct, c.t_slot_perm,
                 lambda m=msg: spmm_edges(ct, m, c.t_slot_perm, backward=True))):
            calls[f"K1 bf16 F={f} {name}"] = fn
            lib = bf16_sparse_mm(lay, cols, msg)
            if lib is not None:
                calls[f"sparse.mm bf16 (K1 bf16 F={f} {name})"] = lib
    return calls


def small_kernels(c: ChunkedCSR, reps: int = SMALL_REPS,
                  ct: Optional[ChunkedCSR] = None) -> dict:
    """``wrapper_split`` of each kernel under 0.15 ms at the slices' shapes, on the
    slices' layout ``c`` (K8 at the int8 cache's fill shape: its pass alone, the scale
    given, and the whole fill the cache runs, ``quantize_int8``), of the library
    calls that compute K10's functions and, given A^T's layout ``ct``, of
    ``k1_bf16_calls``."""
    from dgll_tpu_torch.ops import quantize as q
    from dgll_tpu_torch.ops.cuda import edge_ops as tk
    from dgll_tpu_torch.ops.cuda import gat_fused as gf
    from dgll_tpu_torch.ops.cuda.quantize import quantize_int8_cuda

    dev = c.src.device
    gen = torch.Generator(device=dev).manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    nnz, offsets = c.src.numel(), c.indptr.long()
    e1, e8, r1, r8 = r(nnz, 1), r(nnz, 8), r(c.n_rows, 1), r(c.n_rows, 8)
    v1, s1 = e1[:, 0].contiguous(), r1[:, 0].contiguous()
    m1, den1 = gf.gat_stats_cuda(c, e1, r1)
    m8, den8 = gf.gat_stats_cuda(c, e8, r8)
    x = r(50_000, 256)
    scale = q.column_scale(x)
    calls = {
        "K10 rows_to_edges": lambda: tk.rows_to_edges_cuda(c, s1),
        "index_select (K10 rows_to_edges)": lambda: s1.index_select(0, c.rows),
        "K10 reduce sum (K6 sum, H=1)": lambda: tk.edges_to_rows_cuda(c, v1, "sum"),
        "segment_reduce sum (K10 reduce)": lambda: torch.segment_reduce(
            v1, "sum", offsets=offsets),
        "K10 reduce max (K6 max, H=1)": lambda: tk.edges_to_rows_cuda(c, v1, "max"),
        "segment_reduce max (K10 reduce)": lambda: torch.segment_reduce(
            v1, "max", offsets=offsets),
        "K3 H=1": lambda: gf.gat_stats_cuda(c, e1, r1),
        "K4 H=8": lambda: gf.gat_alpha_cuda(c, e8, r8, m8, den8),
        "K4 H=1": lambda: gf.gat_alpha_cuda(c, e1, r1, m1, den1),
        "K5 H=1": lambda: gf.gat_bwd_softmax_cuda(c, e1, e1, e1, r1),
        "K6' H=8": lambda: tk.rows_to_edges_multi_cuda(c, r8),
        "K6 sum H=8": lambda: gf.edges_to_rows_sum_cuda(c, e8),
        "K8 fill 50000x256": lambda: quantize_int8_cuda(x, scale, "xla"),
        "K8 whole fill 50000x256": lambda: q.quantize_int8(x),
    }
    if ct is not None:
        calls.update(k1_bf16_calls(c, ct, gen))
    return {name: wrapper_split(fn, reps) for name, fn in calls.items()}


PHASES = ("sampling", "gather", "forward", "backward", "optimizer")


def phase_split(runner, state, feats, labels) -> dict:
    """ms a batch of each of ``PHASES``, over one epoch of replays of a graph of the
    runner's step with timing events captured between the phases (each replay waited
    for, so that its events can be read)."""
    marks = [torch.cuda.Event(enable_timing=True, external=True)
             for _ in range(len(PHASES) + 1)]
    runner.load_epoch()
    graph = runner.capture(state, feats, labels, marks)
    total = np.zeros(len(PHASES))
    for _ in range(runner.n_batches):
        graph.replay()
        marks[-1].synchronize()
        total += [marks[k].elapsed_time(marks[k + 1]) for k in range(len(PHASES))]
    return dict(zip(PHASES, (total / runner.n_batches).tolist()))


def device_sampling_profile(runner, state, feats, labels) -> dict:
    """A warm-up epoch (the capture), then one epoch of replays under the profiler
    and ``phase_split``: every number of ``--device_sampling`` but the card's."""
    float(runner.run_epoch(state, feats, labels)[1])
    prof = profile(lambda: float(runner.run_epoch(state, feats, labels)[1]))
    nb = runner.n_batches
    return {"window": runner.window, "sampler": runner.sampler, "n_batches": nb,
            "profile": prof,
            "ms_per_batch": {"wall": prof["wall_ms"] / nb, "busy": prof["busy_ms"] / nb},
            "phases_ms_per_batch": phase_split(runner, state, feats, labels)}


def print_device_sampling(res: dict) -> None:
    split, per = res["phases_ms_per_batch"], res["ms_per_batch"]
    draws = (("block-window" if res["window"] else "per-slot")
             if res["sampler"] == "neighbor" else res["sampler"])
    print(f"slice: {res['model']}, device sampling ({draws}), {res['n_batches']} "
          "batches an epoch")
    _print_profile("replayed a CUDA graph a batch", res["profile"], "1 epoch")
    print(f"per batch: wall {per['wall']:.4f} ms, busy {per['busy']:.4f} ms; phases (CUDA "
          f"events in the graph): " + _entry_line(split)
          + f", sum {sum(split.values()):.4f} ms")


def profile_device_sampling(card: str, sampler: str = "neighbor") -> dict:
    """``device_sampling_profile`` of the headline bench's flagship at its sizes, or
    with ``sampler`` fastgcn or ladies of the layer-wise configuration on its data."""
    from dgll_tpu_torch import bench

    data = bench.flagship_data("cuda")
    extra = {}
    if sampler == "neighbor":
        runner, state = bench.flagship_runner(
            data, int(os.environ.get("BENCH_BATCH", 1024)),
            os.environ.get("BENCH_WINDOW", "1") == "1")
        model = "GraphSAGE flagship"
    else:
        t0 = time.perf_counter()
        lap = bench.layerwise_lap(data)
        extra["build_device_lap_s"] = time.perf_counter() - t0
        print(f"build_device_lap: {extra['build_device_lap_s']:.3f} s")
        runner, state = bench.layerwise_runner(data, lap, sampler)
        model = f"GCN, layer sizes {bench.LAYERWISE_SIZES}"
    result = {"card": card, "model": model, **extra,
              **device_sampling_profile(runner, state, data.feats, data.labels)}
    print(f"card: {card}")
    print_device_sampling(result)
    print(json.dumps(result))
    return result


# the packed host pipeline's loader (benchmarks/epoch_bench.py:335-411)
HOST_PREFETCH, HOST_PRODUCERS = 4, 2


def host_packed_trainer(data, dropout: float = 0.0, cuda_graph=None):
    """``(trainer, state)``: the bench's GraphSAGE (weights from its ``SEED``) under a
    ``MiniBatchTrainer`` on the features' device, Adam 1e-3 (capturable and fused on
    a CUDA device), for the packed host pipeline on ``data`` (``bench.Flagship``)."""
    from dgll_tpu_torch import bench
    from dgll_tpu_torch.nn import GraphSAGE
    from dgll_tpu_torch.train import GRAPH_ADAM, MiniBatchTrainer

    dev = data.feats.device
    model = GraphSAGE(bench.SAGE_FEAT, bench.SAGE_HIDDEN, bench.SAGE_CLASSES,
                      dropout=dropout, generator=torch.Generator().manual_seed(bench.SEED))
    adam = GRAPH_ADAM if dev.type == "cuda" else {}
    tr = MiniBatchTrainer(model, functools.partial(torch.optim.Adam, lr=1e-3, **adam),
                          seed=bench.SEED, device=dev, cuda_graph=cuda_graph)
    return tr, tr.init_state()


def host_packed_loader(data, host_graph, nodes=None, seed: int = 0, packed: bool = True):
    """The packed host pipeline's loader over ``nodes`` (the bench's train nodes by
    default): batch 1024, ``HOST_PRODUCERS`` producer threads, ``HOST_PREFETCH``
    batches ahead, each moved to the features' device by the producer; with
    ``packed=False`` the same loader yielding blocks."""
    from dgll_tpu_torch import bench
    from dgll_tpu_torch.dataloader import DataLoader
    from dgll_tpu_torch.sampling import NeighborSampler

    return DataLoader(host_graph, data.train_nodes if nodes is None else nodes,
                      NeighborSampler(bench.FANOUTS, seed=0), 1024,
                      prefetch=HOST_PREFETCH, seed=seed, device=data.feats.device,
                      n_producers=HOST_PRODUCERS, packed=packed)


def host_packed_profile(tr, state, loader, data) -> dict:
    """A warm-up epoch (the capture), then one packed epoch under the profiler: every
    number of ``--host_packed`` but the card's."""
    from dgll_tpu_torch import bench

    def epoch():
        return tr.run_epoch_packed(state, loader, data.feats, data.labels, bench.FANOUTS)

    epoch()
    prof = profile(epoch)
    nb = len(loader)
    return {"n_batches": nb, "profile": prof,
            "ms_per_batch": {"wall": prof["wall_ms"] / nb, "busy": prof["busy_ms"] / nb}}


def profile_host_packed(card: str) -> dict:
    """``host_packed_profile`` on the headline bench's data."""
    from dgll_tpu_torch import bench
    from dgll_tpu_torch.sampling import HostGraph

    data = bench.flagship_data("cuda")
    tr, state = host_packed_trainer(data)
    loader = host_packed_loader(data, HostGraph(data.indptr, data.src, data.n_node))
    result = {"card": card, "model": "GraphSAGE flagship, packed host pipeline",
              **host_packed_profile(tr, state, loader, data)}
    print(f"card: {card}")
    _print_profile("packed host pipeline, a CUDA-graph replay a batch", result["profile"],
                   f"1 epoch of {result['n_batches']} batches")
    per = result["ms_per_batch"]
    print(f"per batch: wall {per['wall']:.4f} ms, busy {per['busy']:.4f} ms")
    print(json.dumps(result))
    return result


def _entry_line(entry: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in entry.items())


def _print_profile(name: str, p: dict, span: str = f"{STEPS} epochs") -> None:
    print(f"{span}, {name}: wall {p['wall_ms']:.3f} ms, device busy "
          f"{p['busy_ms']:.3f} ms, idle {100 * p['idle_share']:.2f}%")
    for k, v in p["kernels"].items():
        print(f"    {100 * v['share']:6.2f}%  {v['ms']:10.3f} ms  x{v['count']:<4d} {k}")
    k1 = p["k1"]
    print(f"    {100 * k1['share']:6.2f}%  {k1['ms']:10.3f} ms  x{k1['count']:<4d} K1, "
          f"both passes (segment_matmul.cu)")


def profile_clustered(card: str) -> dict:
    """Profiles of ``STEPS`` bench steps on the clustered graph, per layout."""
    from dgll_tpu_torch import bench

    result = {"card": card, "model": "GCN, clustered full-graph bench", "profile": {}}
    print(f"card: {card}, slice: clustered full-graph GCN (dgll_tpu_torch.bench)")
    for layout in ("auto", "chunked"):
        b = bench.setup("cuda", layout)
        losses: list = []
        b.run(2, losses)  # warm-up: cuBLAS handles, the allocator, the kernels
        prof = profile(lambda: b.run(STEPS, losses))
        _print_profile(f"layout {layout}", prof)
        result["profile"][layout] = prof
        del b
    print(json.dumps(result))
    return result


def profile_small(card: str) -> dict:
    """``small_kernels`` on the slices' graph."""
    from dgll_tpu_torch.run import build_dataset
    from dgll_tpu_torch.utils import parse_train_config

    g = build_dataset(parse_train_config(SLICE_ARGS)).with_chunked()
    split = small_kernels(g.chunked.to("cuda"), ct=g.chunked_t.to("cuda"))
    print(f"card: {card}, small kernels on the slices' graph, ms a call ({SMALL_REPS} "
          f"calls): CUDA events around the call, device time, host time")
    for name, entry in split.items():
        print(f"    {name}: " + _entry_line(entry))
    result = {"card": card, "small_kernels": split}
    print(json.dumps(result))
    return result


def main(argv=None) -> dict:
    from dgll_tpu_torch.utils import parse_train_config

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = p.add_mutually_exclusive_group()
    which.add_argument("--gat", action="store_true", help="profile the GAT slice")
    which.add_argument("--clustered", action="store_true",
                       help="profile the full-graph bench's step on the clustered graph")
    which.add_argument("--small", action="store_true",
                       help="split the small kernels' times into device and host time")
    which.add_argument("--device_sampling", action="store_true",
                       help="profile the headline bench's replayed epoch and split it "
                            "into phases")
    which.add_argument("--host_packed", action="store_true",
                       help="profile an epoch of the packed host pipeline at the "
                            "headline bench's sizes")
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                   help="with --gat: the slice's --dtype (bfloat16 profiles only the "
                        "epochs)")
    p.add_argument("--sampler", default="neighbor", choices=("neighbor", "fastgcn", "ladies"),
                   help="with --device_sampling: the flagship's neighbour sampler, or "
                        "the layer-wise configuration's FastGCN or LADIES")
    args = p.parse_args(argv)
    if args.sampler != "neighbor" and not args.device_sampling:
        p.error("--sampler goes with --device_sampling")
    if args.dtype != "float32" and not args.gat:
        p.error("--dtype goes with --gat")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.clustered:
        return profile_clustered(card)
    if args.small:
        return profile_small(card)
    if args.device_sampling:
        return profile_device_sampling(card, args.sampler)
    if args.host_packed:
        return profile_host_packed(card)
    gat = args.gat
    cfg = parse_train_config([*GAT_SLICE_ARGS, "--dtype", args.dtype] if gat
                             else SLICE_ARGS)
    prof, g, n_class = profile_training(cfg, STEPS)
    sweep = probe = None
    if gat and cfg.dtype == "float32":
        probe = hub_probe(g.chunked, (cfg.nhid * cfg.n_heads, n_class), HUB, CAP,
                          heads=cfg.n_heads)
        sweep = split_sweep(g.chunked, (cfg.n_heads, 1))
    elif not gat:
        probe = hub_probe(g.chunked, (cfg.nhid, n_class), HUB, CAP)

    print(f"card: {card}, slice: {cfg.model}, {cfg.dtype}")
    for name, p in (("train only", prof["train_only"]),
                    ("with validation", prof["with_validation"])):
        _print_profile(name, p)
    result = {"card": card, "model": cfg.model, "dtype": cfg.dtype, "profile": prof}
    if probe is not None:
        print(f"hub probe: {probe['hub_rows']} rows above {HUB} edges, "
              f"max in-degree {probe['max_degree']}")
        for name, entry in probe["layouts"].items():
            print(f"    {name}: " + _entry_line(entry))
        result["hub_probe"] = probe
    if sweep is not None:
        print("K3 and K5 on A by split threshold:")
        for name, entry in sweep.items():
            print(f"    {name}: " + _entry_line(entry))
        result["split_sweep"] = sweep
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
