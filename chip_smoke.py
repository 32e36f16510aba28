#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout and drives the
port's ten slices: two through the port's CLI (``dgll_tpu_torch.run.main``) on a
200k-node power-law graph, the third through the full-graph bench
(``dgll_tpu_torch.bench``) on a 200k-node clustered graph, the fourth through the
round-4 attention ops (``dgll_tpu_torch.ops``) on the power-law graph, the fifth
through the CLI's host minibatch path and the library's feature cache, the sixth
through the primitive probe (``dgll_tpu_torch.tools.probe``), the seventh, the
flagship, through the headline bench and the CLI's device-sampling branch, the
eighth through the packed host pipeline (``MiniBatchTrainer.run_epoch_packed``),
``PipelinedTrainer`` and the CLI's ``--preprocess``, the ninth through the layer-wise
samplers' device epoch, the CLI's layer-wise and GIN branches and GIN graph
classification, the tenth through the CLI's bfloat16 GAT, its dataset files,
checkpoints and ``device_trace``:

* full-batch GCN (phases 3-5): the SpMM kernel K1 against its plain PyTorch version
  on a power-law test graph and on a planted graph whose rows cross K1's split
  threshold (T-1, T, T+1, 2T, 2T+1 and 60,000 edges), and, through the autograd
  wrapper, at the slice's shapes; both timed there; 20 epochs of training, in which
  the CLI tries the windowed layout and declines it;
* full-batch GAT, 8 heads x 8 features (phases 6-9): the attention kernels K3-K7
  and K1 with runtime columns against their plain versions on the test graph, K3,
  K5 and K6 on the planted graph whose rows cross their split threshold (H 1, 3
  and 8; K3's row max exact), and K4 on copies of the test graph with every residue
  of nnz % 4, in each variant of its edge-major mapping (lgrad exact); the fused
  layer's forward and backward against the plain
  composition at the slice's shapes; each kernel and its plain version timed there;
  20 epochs of training;
* full-batch GCN on the clustered graph (phases 10-12): the windowed kernel K2
  against its plain version on a clustered test graph, on one whose row blocks hold
  0 to 17 sub-chunks (every state of K2's ring of stages) and on one with an empty
  row block; the hybrid op (K2 plus K1 on the residual edges) forward and backward at
  the bench's shapes; K2, the hybrid op and K1 over the whole graph timed there; the
  bench's 14 train steps through K2, and again through K1 alone;
* the round-4 GAT attention layers (phases 13-15): K6 in its max mode, K9, K6′,
  K10's rows-to-edges (K6′'s kernel at one head) and K10's reduction (K6's kernel
  through a counted wrapper) against their plain versions on the test graph, K6 and
  K10 also on the planted graph (H 1, 3 and 8), K10's rows-to-edges and K6′ (H 1, 2,
  3 and 8) on every residue of nnz % 4; ``gat_attention_chunked_multihead`` (8 heads x
  8 features) and ``gat_attention_chunked`` (one head, F=16 and F=64) forward and
  backward against the fused op at the slice's shapes, with every launch counted;
  each kernel and both layers timed;
* the host minibatch path (phases 16-18): the int8 quantizer K8 against its plain
  version, exactly, in both rounding modes, without noise, with supplied noise and
  with its in-kernel Philox noise: its pass alone at the tests' shapes and the int8
  cache's, and its whole fill (column maxima, scales and pass in one call) on ten
  shapes with zero and NaN columns, misaligned inputs and d % 4 != 0; both timed at
  the cache's shape, the fill in turns with the composition it replaces, and its
  peak memory beside the composition's; the
  CLI's minibatch GraphSAGE (with the feature cache on 25% of the rows) and GCN
  runs, 3 epochs each, with each batch's time split into sampling, copies, feature
  fetch and the device step, and the device's idle share over an epoch; the feature
  cache's scenario (``benchmarks/cache_bench.py``): a device-resident run, float32
  caches on 0, 25 and 100% of the rows, and float32 against int8 at one byte budget,
  with the int8 fill's K8 launch counted and its peak memory;
* the primitive probes P0-P4 (phase 19): each probe's kernel against its plain
  version on ragged shapes and at the probe script's full sizes (E 2^22 rows of 128
  floats; P0, P2, P4 exact, P2b bitwise, P3 within rtol 1e-4 and 1e-5 x max|ref|;
  P2b also on ragged tiles and window widths, values from 1e-30 to 1e30, bitwise,
  with its kernel's registers and spills from the build), each timed beside its
  plain version, ``copy_``, ``index_select`` or ``index_add_``, and its bound; P4 in
  both of its paths (direct and bucketed) on the ragged cases, at the probe's size,
  at GAT's ``h[src]`` gather and at item 1's feature gather, timed beside
  ``index_select``; P0 against ``copy_`` and ``clone`` in
  alternating turns; P3 again with every row sent to 64 or 1,024
  destination rows (contended atomics, integer values: exact); then the probe
  tool's run at those sizes, whose JSON (with ``index_select`` as P1 and P0's
  achieved bandwidth) it prints;
* the flagship, minibatch GraphSAGE with device sampling (phase 20), on the headline
  bench's 2.4M-node graph: the device sampler on the card equal to the same function
  on the CPU with the same uniforms, in both modes (train seeds, seeds of degree 0
  and masked seeds, a graph with no edges); 8 batches replayed as a CUDA graph
  against 8 eager steps from the same state and draws, with dropout 0 and 0.5
  (losses and parameters within 1e-6 x max|ref|); the epoch timed in turns, graph
  against eager, block-window against per-slot draws, fused Adam against foreach;
  one replayed epoch profiled (idle share) and split into its phases
  (``profile_slice --device_sampling``); the bench's ``main`` (its JSON line); then
  the CLI's ``--device_sampling`` runs on the 200k-node graph: GraphSAGE and GCN with
  ``--exact_eval`` (GCN's exact inference launches K1) and GAT, 3 epochs each;
* the packed host pipeline (phase 21), on the same 2.4M-node data (built once for
  phases 20 and 21), in the configuration of ``benchmarks/epoch_bench.py:335-411``
  (GraphSAGE, hidden 256, fanouts [15, 10], batch 1024, Adam 1e-3, a
  ``DataLoader(packed=True)`` with two producer threads and 4 batches ahead): 8 packed
  steps replayed as a CUDA graph against 8 eager ones (bitwise equal) and groups of 3
  with a padded tail against single steps (within 1e-5 x max|ref|), with dropout 0
  and 0.5; ms a batch including sampling of the packed epoch, grouped (8), routed by
  the link probe (``group="auto"``, its group, bandwidth and round trip printed),
  eager, and the unpacked ``run_epoch`` on the same loader settings, in turns; one
  packed epoch profiled (``profile_slice --host_packed``); then, on the 200k-node
  graph, one epoch of ``PipelinedTrainer`` with a 25% cache (its load/compute split
  and miss rate), ``fused_gcn_layer`` forward and backward against the CPU at width
  128, and the CLI's ``--preprocess`` runs on the host and the device-sampling path;
* the layer-wise samplers and GIN (phase 22), on the same 2.4M-node data:
  ``build_device_lap`` timed; FastGCN and LADIES on the card against the CPU with the
  same uniforms, layer by layer (train seeds, seeds of in-degree 0 and masked seeds;
  FastGCN's ids and slots exact, weights within 1e-6 relative; LADIES's ids exact but
  where a uniform lies within rounding of a prefix-sum boundary, counted); 8 batches
  replayed as a CUDA graph against 8 eager steps for each, dropout 0 and 0.5; the
  products-scale epoch of ``benchmarks/epoch_bench.py:195-271`` (GCN, hidden 256,
  layer sizes [2048, 1024], ELL width 32, batch 1024), ms a batch including sampling
  beside the reference's 6.12 ms (``vs_dgll_products_batch``), its peak memory, one
  profiled epoch's idle share and phases; then, on the 200k-node graph, the CLI's
  FastGCN and LADIES runs on the host and the device path (``--flatten``; LADIES's
  ``--exact_eval`` launches K1), ``--Model GIN --samp_type full`` for 20 epochs with
  K1's launches held to the model's count, ``--Model GIN --device_sampling``, and GIN
  graph classification on 128 synthetic graphs (the example's width 32, 3 layers,
  sum and mean pooling) through K1, its forward on the card against the CPU's;
* GAT in bfloat16 (phase 23), on the slices' graph: K7 on bf16 rows against its
  plain version, bitwise, in 16-byte units and an element a unit (unaligned, F=12);
  K1's bfloat16 route on bf16 messages with identity columns on A and
  ``t_slot_perm`` columns on A^T, within 1 bf16 ulp of the float64 sum beyond the
  bound of the float32 sum in K1's own order (a segment of at most 512 edges, then
  the segments) and beside its plain version, bitwise repeatable and equal to the
  same sums with loaded columns and weights, at F 64, 16 and 12, aligned and one
  element off, on the slices', power-law, planted and tail layouts; its general case
  (the layout's columns and weights, bias and ReLU) into bf16 and float32; K7 and K1
  at widths 64 and 16 timed beside ``index_select`` or ``sparse.mm`` on a bf16 CSR;
  the CLI's GAT slice under ``--dtype bfloat16`` for 20 epochs (K1 and K7 launches
  counted, every K1 launch on the bfloat16 route) beside phase 9's float32 run, and
  a bf16 ``--device_sampling`` run; then
  ``save_graph``/``load_graph`` of the slice's graph, a ``--checkpoint_dir`` run and
  its ``--resume`` (the restored parameters equal those saved), and two resumed
  epochs on the loaded graph inside ``device_trace``, whose trace names K1 and K7;
* data and graph-partition parallel (phase 24) and the halo exchange, tensor
  parallel, the dry run and DeepWalk (phase 25), each in two ranks sharing the card
  over gloo: phase 25 drives the clustered graph's graph-partition GCN through the
  halo exchange (K1 on each rank's ``[rows, rows + D*H]`` layout), the windowed halo
  SpMM (K2 on each shard's captured edges) and the all-gather, each against the
  one-process K1 GCN with every launch counted; K2 on a shard, K1 on the halo layout
  and K1 on a tensor-parallel slice against their plain versions and timed; the TP
  GCN against one process; ``dryrun_multichip(2)``; DeepWalk's skip-gram on the card
  against the CPU and an epoch timed;
* full-batch GraphSAGE's aggregation (phase 26), on an ogbn-arxiv-sized power-law
  graph (169,343 nodes, 2,501,829 edges with both directions and self-loops; the
  benchmark's degree law): ``Graph.mean_chunked`` built on the card and timed,
  then ``spmm_chunked`` forward and autograd backward on it at F 128 and 512 (SAGE's
  two layers) against the plain version through autograd (1e-5 x max|ref|), every
  launch counted; K1 on A and A^T at both widths timed beside the plain version,
  ``sparse.mm`` and its bound, and the COO mean it replaced (``spmm_mean_coo``);
* full-batch GCNII's propagation (phase 27), on the same graph:
  ``Graph.gcn_chunked`` (``D^-1/2 (A + I) D^-1/2``) built on the card and timed, then
  ``spmm_chunked`` forward and autograd backward on it at F 64 (GCNII's width)
  against the plain version through autograd (1e-5 x max|ref|), every launch
  counted; K1 on A and A^T timed beside the plain version, ``sparse.mm`` and its
  bound;
* GCNII's fused layer (phase 28): its forward and backward kernels
  (``csrc/gcnii_fused.cu``) at ``[169343, F]`` against the composition they replace
  through autograd (1e-5 x max|ref|; the masks equal to ``_dropout``'s, the flags to
  the composition's off the sign of a rounding; bitwise repeatable, ``dW`` included),
  at F 64 (GCNII's width, the kernels with W whole in shared memory) and at F 128 and
  256 (the tiled kernels), each timed beside the plain formulas and the composition;
  one 64-layer training step on the same graph through the model and through the
  composition written out, from one state and generator seed (loss and gradients held
  to each other, 64 launches of each kernel, each step's ms).

Each slice's launch counters are set to 0 just before its run and read just after.
Each kernel is timed beside its plain version, one PyTorch library call computing
the same function where there is one (``library_ms``; the port never calls it; in
phases 4, 8, 15 and 16 the three in turns), and its bound: the larger of its bytes (each input read once, each output written once)
over the H100's 3.35 TB/s and its float32 operations over 67 TFLOP/s (P2b's one
product over TF32's 495 TFLOP/s). It needs one
CUDA device and ``nvcc`` (``CUDA_HOME`` or ``PATH``), and no JAX.

Each phase prints its lines; a failed check raises and the script exits non-zero.
Before the last line it prints the card's name and power limit, as ``nvidia-smi``
gives them, and one JSON line describing the kernels. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import io
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

EPOCHS = 20  # phases 5 and 9 train each slice for this many epochs
KERNEL_SOURCE = "dgll_tpu_torch/csrc/segment_matmul.cu"
REPLACES = "dgll_tpu/ops/pallas/segment_matmul.py:34"
GAT_SOURCE = "dgll_tpu_torch/csrc/gat_csr.cu"
# the GAT kernels: (JSON name, wrapper's counter name, the TPU kernel it replaces)
GAT_KERNELS = (
    ("gat_stats (K3: per-row softmax max and sum)", "gat_stats",
     "dgll_tpu/ops/pallas/gat_fused.py:46"),
    ("gat_alpha (K4: per-edge attention and LeakyReLU slope)", "gat_alpha",
     "dgll_tpu/ops/pallas/gat_fused.py:135"),
    ("gat_bwd_softmax (K5: softmax VJP and its row sum)", "gat_bwd_softmax",
     "dgll_tpu/ops/pallas/gat_fused.py:248"),
    ("edges_to_rows_sum (K6, sum mode)", "edges_to_rows_sum",
     "dgll_tpu/ops/pallas/edge_ops.py:293"),
    ("expand_rows (K7: destination rows to edges)", "expand_rows",
     "dgll_tpu/ops/pallas/expand_rows.py:20"),
)
K1_GAT = "spmm_csr (K1) with runtime columns and unit weights: GAT aggregation and scatter"
# outputs a kernel computes exactly as its plain version does, whatever the tolerance
# of the others: K3's row max m (a max does not round), K4's lgrad (a compare and a
# select on the same float32 sum)
EXACT_OUTPUTS = {"gat_stats": (0,), "gat_alpha": (1,)}
# head counts of the planted-graph cases of K3, K5 and K6 (phases 6 and 13): across
# lanes (1, 8) and one pass a head (3)
SPLIT_HEADS = (1, 3, 8)
# the row reductions held on the planted graph: phase 6's (GAT counters) and phase
# 13's (round-4 counters, K10's two launchers at H=1)
SPLIT_GAT = ("gat_stats", "gat_bwd_softmax", "edges_to_rows_sum")
SPLIT_R4 = ("edges_to_rows_max", "sum_all", "rows_to_edges", "edges_to_rows:sum",
            "edges_to_rows:max")
# edge counts of phase 13's K10 rows-to-edges cases: every residue of nnz % 4, and
# layouts too small for one group of 4 edges
R2E_TAILS = (1, 2, 3, 10_001, 10_002, 10_003, 10_004)
# head counts of K6′'s cases (phase 13) on the layouts of every nnz % 4
# (tail_layouts; K4's take SPLIT_HEADS): 4 edges a unit (1), 4 heads a unit (8) and
# an edge a unit (2, 3); and of K4's further cases on one of them: every instance of
# the 4-heads kernel (4, 8, 16, 32, 64 heads; at 12 it divides by G at run time)
R2E_MULTI_HEADS = (1, 2, 3, 8)
K4_MORE_HEADS = (4, 12, 16, 32, 64)
WINDOWED_SOURCE = "dgll_tpu_torch/csrc/spmm_windowed.cu"
WINDOWED_REPLACES = "dgll_tpu/ops/pallas/spmm_windowed.py:42"
# windowed_fraction of A on the bench's clustered graph, as the JAX builder gives it
BENCH_FRACTION = 0.9068
EDGE_OPS = "dgll_tpu/ops/pallas/edge_ops.py"
# the kernels of the round-4 attention path: (JSON name, counter, the TPU kernel it
# replaces); the counters are phase 14's (see _counters)
R4_KERNELS = (
    ("edges_to_rows_max (K6, max mode)", "edges_to_rows_max", f"{EDGE_OPS}:293"),
    ("edges_to_rows_sum (K6, sum_all mode: the sum kernel)", "sum_all", f"{EDGE_OPS}:293"),
    ("rows_to_edges_multi (K6': its own kernel, K4's edge-major mapping)",
     "rows_to_edges_multi", f"{EDGE_OPS}:249"),
    ("rows_to_edges (K10 rows to edges: K6''s kernel at H=1, 4 edges a thread)",
     "rows_to_edges", f"{EDGE_OPS}:39"),
    ("edges_to_rows, sum (K10 reduce, sum and sum_all: K6's sum kernel at H=1)",
     "edges_to_rows:sum", f"{EDGE_OPS}:77"),
    ("edges_to_rows, max (K10 reduce, max: K6's max kernel at H=1)", "edges_to_rows:max",
     f"{EDGE_OPS}:77"),
    ("sddmm_edges (K9: per-edge dot products)", "sddmm_edges",
     "dgll_tpu/ops/pallas/sddmm.py:27"),
)
QUANTIZE_SOURCE = "dgll_tpu_torch/csrc/quantize.cu"
QUANTIZE_REPLACES = "dgll_tpu/ops/quantize.py:89"
# the CLI's host minibatch runs (phase 17): the slices' graph, the JAX CLI's default
# fanouts and batch, hidden width 256
MINIBATCH_ARGS = ["--samp_type", "neighbor", "--n_node", "200000", "--avg_degree", "16",
                  "--feat_dim", "128", "--n_class", "16", "--nhid", "256",
                  "--n_stops", "0", "--device", "cuda"]
MINIBATCH_RUNS = (("GraphSAGE, cache 25%", ["--Model", "GraphSAGE", "--cached_nPercent", "25"]),
                  ("GCN, no cache", ["--Model", "GCN"]))
MINIBATCH_EPOCHS = 3
# the H100 SXM's peak rates (NVIDIA's data sheet): device memory and float32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12   # dense, on the tensor cores
PROBES_SOURCE = "dgll_tpu_torch/csrc/probes.cu"
PROBE_SCRIPT = "benchmarks/pallas_probe_r4.py"
# the primitive probes (phase 19): (JSON name, counter, body line of the TPU kernel)
PROBE_KERNELS = (
    ("p0_copy (P0: streaming copy)", "p0_copy", 53),
    ("p2_dynread (P2: window gather from shared memory)", "p2_dynread", 72),
    ("p2b_onehot (P2b: one-hot product on wgmma, the window split exactly into three "
     "bf16 parts)", "p2b_onehot", 102),
    ("p3_dynacc (P3: scatter-add through L2 atomics, zeroing included)", "p3_dynacc", 126),
    ("p4_dma (P4: row gather, in order or bucketed by table slice, as p4_plan picks)",
     "p4_dma", 171),
)
# P3 under contention (phase 19): all E message rows into this many destination rows
P3_HUB_ROWS = (64, 1024)
# a kernel case: its launch, its plain version, one library call computing the same
# function (or None), the tensors it reads and its float32 operations
Case = collections.namedtuple("Case", "kernel plain library reads ops")

warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
warnings.filterwarnings("ignore", "Sparse invariant checks are implicitly disabled")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved: int, ops: int, ops_per_s: float = F32_OPS_PER_S) -> tuple:
    """``(bound_ms, bound_by)``: the least time the card could take to move
    ``moved`` bytes and do ``ops`` operations at its peak rates (float32 outside the
    tensor cores unless ``ops_per_s`` says otherwise)."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_reads(lay, x) -> tuple:
    """What K1 on ``lay`` must read, each once: its CSR and only the rows of ``x``
    that its edges name (a shard or halo layout leaves many rows unread)."""
    return (lay.indptr, lay.src, lay.weight,
            x.index_select(0, torch.unique(lay.src.long())))


def csr(indptr, cols, values, shape):
    """A layout's edges as a torch sparse CSR matrix, the input of a library call."""
    return torch.sparse_csr_tensor(indptr, cols, values, size=shape,
                                   check_invariants=False)


def timed(case: Case, outs) -> dict:
    """A case's kernel, plain and library times and bound, for the outputs ``outs``
    of its kernel. Each time is the mean of two medians of 15 CUDA-event timings
    after 3 warm-ups, taken in turns (kernel, plain, library, library, plain,
    kernel), so that a drift of the card or the host during the case falls on all
    three alike: below 0.1 ms it moved one call's reading by up to 17%."""
    from dgll_tpu_torch.utils.profiling import cuda_median_ms

    calls = {"ms": case.kernel, "plain_ms": case.plain, "library_ms": case.library}
    order = [k for k, fn in calls.items() if fn is not None]
    ms = collections.defaultdict(list)
    for k in order + order[::-1]:
        ms[k].append(cuda_median_ms(calls[k]))
    b_ms, b_by = bound(nbytes(*case.reads, *outs), case.ops)
    return {"library_ms": None, **{k: sum(v) / len(v) for k, v in ms.items()},
            "bound_ms": b_ms, "bound_by": b_by}


def describe(t: dict) -> str:
    lib = "none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
    return (f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms "
            f"({t['plain_ms'] / t['ms']:.2f}x"
            f"{'; kernel SLOWER than plain' if t['ms'] > t['plain_ms'] else ''}), "
            f"library {lib}, bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
            f"({t['bound_ms'] / t['ms']:.1%} of it)")


def phase_env() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available()")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from dgll_tpu_torch.ops.cuda.build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout
    release = next((l for l in nvcc.splitlines() if "release" in l), nvcc.strip())
    print(f"[1 env] {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| nvcc: {release.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    from dgll_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    so = build.build()
    build.load_library()
    dt = time.perf_counter() - t0
    log = so.with_suffix(".log")
    text = log.read_text() if log.exists() else ""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", text))
    print(f"[2 build] {so.name} in {dt:.2f} s; {len(regs)} kernel instances, "
          f"registers {min(regs, default=0)}-{max(regs, default=0)}, "
          f"spill stores {spills} bytes")


def power_law_layouts(n=50_000, e=800_000, device="cuda", seed=0):
    """A random power-law graph (hub rows, a 128-row block with no edges, edgeless
    tail rows) as the kernel's layouts of A and A^T on ``device``."""
    from dgll_tpu_torch.ops import build_chunked_pair

    rng = np.random.default_rng(seed)
    p = (np.arange(n) + 1.0) ** -1.0
    p /= p.sum()
    dst = rng.choice(n, size=e, p=p)
    src = rng.integers(0, n, e)
    keep = ~((dst >= n // 2) & (dst < n // 2 + 128))
    src, dst = src[keep], dst[keep]
    w = rng.random(len(src)).astype(np.float32)
    c, ct = build_chunked_pair(src, dst, n, n, w)
    return c.to(device), ct.to(device), n


def planted_layouts(n=20_000, e=200_000, device="cuda", seed=3):
    """K1's split boundaries: rows 0..7 of A have T-1, T, T+1, 2T, 2T+1, 0, 1 and
    60,000 in-edges (T = ``SPLIT_EDGES``), rows 8..255 none (an edgeless 128-row
    block among them), the rest power-law in-degrees; half of each planted row's
    edges come from one source, so that A^T has long rows too. The layouts of A and
    A^T on ``device``."""
    from dgll_tpu_torch.ops import build_chunked_pair
    from dgll_tpu_torch.ops.chunked import SPLIT_EDGES as t

    rng = np.random.default_rng(seed)
    planted = np.array([t - 1, t, t + 1, 2 * t, 2 * t + 1, 0, 1, 60_000])
    dst = np.repeat(np.arange(len(planted)), planted)
    src = np.where(np.arange(len(dst)) % 2 == 0, n - 1 - dst, rng.integers(0, n, len(dst)))
    p = (np.arange(n - 256) + 1.0) ** -1.0
    rest = 256 + rng.choice(n - 256, size=e, p=p / p.sum())
    dst, src = np.concatenate([dst, rest]), np.concatenate([src, rng.integers(0, n, e)])
    c, ct = build_chunked_pair(src, dst, n, n, rng.random(len(src)).astype(np.float32))
    check(np.array_equal(np.diff(c.indptr[:9].numpy()), planted), "the planted degrees")
    return c.to(device), ct.to(device), n


@functools.cache
def tail_layouts():
    """The power-law test graph's layout of A with its last 0, 1, 2 and 3 edges
    dropped, on the card: ``{nnz % 4: layout}`` for every residue."""
    from dgll_tpu_torch.ops.chunked import build_chunked

    c, _, n = power_law_layouts(device="cpu")
    src, rows, w = (t.numpy() for t in (c.src, c.rows, c.weight))
    out = {}
    for k in range(4):
        m = len(src) - k
        out[m % 4] = build_chunked(src[:m], rows[:m], n, n, w[:m]).to("cuda")
    check(sorted(out) == [0, 1, 2, 3], "a layout for every nnz % 4")
    return out


def _split_summary(c) -> str:
    sc = c.split
    deg = c.indptr[1:] - c.indptr[:-1]
    return (f"max in-degree {int(deg.max())}, {sc.n_split} rows above {sc.max_edges} "
            f"edges split into {sc.n_seg} segments")


def _kernel_case(c, ct, n, f, dtype, activation, gen):
    """Kernel forward + backward against the plain version; returns the max error
    over out, dx and db relative to the case's bound (f32: 1e-4 * max|ref|; bf16:
    |err| / max(|ref|, 1) against 1e-2) and whether two runs were bitwise equal."""
    from dgll_tpu_torch.ops import spmm_chunked_reference
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_chunked

    dev = c.src.device
    x0 = torch.randn(n, f, generator=gen, device=dev).to(dtype)
    b0 = torch.randn(f, generator=gen, device=dev) if activation else None
    cot = torch.randn(c.n_rows, f, generator=gen, device=dev)

    def run():
        x = x0.clone().requires_grad_(True)
        b = None if b0 is None else b0.clone().requires_grad_(True)
        out = spmm_chunked(c, ct, x, b, activation)
        (out.float() * cot).sum().backward()
        return out.detach(), x.grad, None if b is None else b.grad

    out, dx, db = run()
    out2, dx2, db2 = run()
    same = torch.equal(out, out2) and torch.equal(dx, dx2) and (
        db is None or torch.equal(db, db2))

    # plain version in f32 on the same (quantised) inputs; the ReLU gate of the
    # backward is the kernel forward's own, so that sums within rounding of zero
    # cannot flip the comparison
    xr = x0.float().requires_grad_(True)
    br = None if b0 is None else b0.clone().requires_grad_(True)
    pre = spmm_chunked_reference(c, xr, br, None)
    ref = torch.relu(pre) if activation == "relu" else pre
    gated = torch.where(out > 0, pre, 0.0) if activation == "relu" else pre
    (gated * cot.to(dtype).float()).sum().backward()

    errs = {}
    pairs = [("out", out, ref.detach()), ("dx", dx, xr.grad)]
    if db is not None:
        pairs.append(("db", db, br.grad))
    for name, got, want in pairs:
        diff = (got.float() - want).abs()
        if dtype == torch.float32:
            errs[name] = (diff.max() / (1e-4 * want.abs().max())).item()
        else:
            errs[name] = ((diff / want.abs().clamp_min(1.0)).max() / 1e-2).item()
        errs[name + "_abs"] = diff.max().item()
    return errs, same


def phase_check(device="cuda") -> float:
    """Phase 3: K1 forward and backward against its plain version on the power-law
    test graph (F in {16, 128, 256}) and on the planted graph that crosses the split
    boundaries (F in {16, 64, 128, 256}), f32 and bf16, with and without bias + ReLU,
    bitwise repeatable. Returns the max abs error of the f32 cases."""
    gen = torch.Generator(device=device).manual_seed(0)
    worst = 0.0
    graphs = (("power-law", power_law_layouts(device=device), (16, 128, 256)),
              ("planted", planted_layouts(device=device), (16, 64, 128, 256)))
    for name, (c, ct, n), widths in graphs:
        cases = 0
        for f in widths:
            for dtype in (torch.float32, torch.bfloat16):
                for act in (None, "relu"):
                    errs, same = _kernel_case(c, ct, n, f, dtype, act, gen)
                    ratio = max(v for k, v in errs.items() if not k.endswith("_abs"))
                    print(f"[3 check] {name} F={f} {str(dtype)[6:]} act={act}: "
                          f"max abs err out {errs['out_abs']:.3e} dx {errs['dx_abs']:.3e}"
                          + (f" db {errs['db_abs']:.3e}" if "db_abs" in errs else "")
                          + f"; {ratio:.3f} of tolerance; bitwise repeatable {same}")
                    check(ratio <= 1.0, f"kernel within tolerance ({name}, F={f}, {dtype}, "
                                        f"{act})")
                    check(same, f"two runs bitwise equal ({name}, F={f}, {dtype}, {act})")
                    if dtype == torch.float32:
                        worst = max(worst, errs["out_abs"], errs["dx_abs"])
                    cases += 1
        print(f"[3 check] {name}: {c.src.numel()} edges over {n} rows; A: "
              f"{_split_summary(c)}; A^T: {_split_summary(ct)}: all {cases} cases pass")
    return worst


def _slice_check(c, ct, n_in, f, gen) -> float:
    """The wrapper as the slice's GCN layers call it (``spmm_chunked(c, ct, h)``,
    forward and autograd backward on A^T) against the plain version through
    autograd; f32, atol 1e-4 * max|ref| for out and dx. Returns the max abs error."""
    from dgll_tpu_torch.ops import spmm_chunked_reference
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_chunked

    x = torch.randn(n_in, f, generator=gen, device="cuda", requires_grad=True)
    cot = torch.randn(c.n_rows, f, generator=gen, device="cuda")
    out = spmm_chunked(c, ct, x)
    (out * cot).sum().backward()
    xr = x.detach().clone().requires_grad_(True)
    ref = spmm_chunked_reference(c, xr)
    (ref * cot).sum().backward()
    worst = 0.0
    for name, got, want in (("out", out.detach(), ref.detach()), ("dx", x.grad, xr.grad)):
        err = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        print(f"[4 check] F={f} {name} {tuple(got.shape)}: max abs err {err:.3e}, "
              f"tolerance {tol:.3e}")
        check(err <= tol, f"wrapper within tolerance at the slice's shapes (F={f}, {name})")
        worst = max(worst, err)
    return worst


@functools.cache
def slice_graph():
    """The slices' graph (both slices train on the same one), with its kernel
    layouts on the card: (layout of A, layout of A^T, node count)."""
    from dgll_tpu_torch.run import build_dataset
    from dgll_tpu_torch.tools.profile_slice import SLICE_ARGS
    from dgll_tpu_torch.utils import parse_train_config

    g = build_dataset(parse_train_config(SLICE_ARGS)).with_chunked()
    return g.chunked.to("cuda"), g.chunked_t.to("cuda"), g.n_node


def phase_time() -> dict:
    """Phase 4: the wrapper at the slice's shapes, then K1 on A and A^T timed beside
    its plain version, ``torch.sparse.mm`` on the layout's CSR (the same sum; like
    the timed launch, without bias and ReLU) and its bound. Returns {(F, layout):
    times}."""
    from dgll_tpu_torch.ops import spmm_chunked_reference
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_csr_cuda

    c, ct, n_node = slice_graph()
    gen = torch.Generator(device="cuda").manual_seed(1)
    result = {}
    for f in (128, 16):
        err = _slice_check(c, ct, n_node, f, gen)
        for name, lay in (("A", c), ("A^T", ct)):
            x = torch.randn(lay.n_cols, f, generator=gen, device="cuda")
            mat = csr(lay.indptr, lay.src, lay.weight, (lay.n_rows, lay.n_cols))
            case = Case(lambda: spmm_csr_cuda(lay, x),
                        lambda: spmm_chunked_reference(lay, x),
                        lambda: torch.sparse.mm(mat, x),
                        (lay.indptr, lay.src, lay.weight, x), 2 * lay.src.numel() * f)
            t = timed(case, (spmm_csr_cuda(lay, x),))
            nnz = lay.src.numel()
            gbs = (nnz * (f * 4 + 8) + lay.n_rows * f * 4) / (t["ms"] * 1e-3) / 1e9
            print(f"[4 time] F={f} {name}: {describe(t)}; {gbs:.1f} GB/s of gathered "
                  f"rows + indices, {nnz} edges, {_split_summary(lay)}")
            result[(f, name)] = {**t, "err": err}
    return result


def _peak_memory(held: int) -> str:
    """The run's peak device memory, above what the script held before it (the
    slices' layouts, kept for the later phases)."""
    peak = torch.cuda.max_memory_allocated()
    return (f"peak memory {(peak - held) / 2**30:.2f} GiB above the "
            f"{held / 2**30:.2f} GiB held before the run")


def phase_slice() -> dict:
    from dgll_tpu_torch import run
    from dgll_tpu_torch.ops.cuda import segment_matmul as sm
    from dgll_tpu_torch.tools.profile_slice import SLICE_ARGS

    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    from dgll_tpu_torch.ops.cuda import spmm_windowed as sw

    sm.launches_fwd = 0
    sm.launches_bwd = 0
    sw.launches_fwd = sw.launches_bwd = 0
    with contextlib.redirect_stdout(io.StringIO()):  # the CLI's own JSON line
        out = run.main([*SLICE_ARGS, "--n_epochs", str(EPOCHS)])
    fwd, bwd = sm.launches_fwd, sm.launches_bwd
    trial = out["trials"][0]
    # the CLI graph lacks the locality: the windowed layout declines, K1 runs
    check("locality_reordered" not in trial, "the CLI graph was not relabelled")
    check(sw.launches_fwd == sw.launches_bwd == 0, "no K2 launch in the GCN slice")
    losses, secs = trial["epoch_loss"], trial["epoch_s"]
    epochs = trial["epochs"]
    check(epochs == EPOCHS, f"{EPOCHS} epochs ran")
    check(all(np.isfinite(losses)), "every loss is finite")
    check(losses[-1] < losses[0], "the last loss is below the first")
    check(trial["test_acc"] > 2 / 16, "test_acc above 2/16")
    check(trial.get("spmm_kernel") == run.SPMM_KERNEL, "the slice names the kernel")
    check(fwd >= 2 * epochs, "at least 2 forward launches per epoch")
    check(bwd == 2 * epochs, "exactly 2 backward launches per epoch")
    steady = secs[1:]
    print(f"[5 slice] {epochs} epochs: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"test_acc {trial['test_acc']:.4f}, epoch ms mean {1e3 * np.mean(secs):.3f} "
          f"(first {1e3 * secs[0]:.3f}, rest mean {1e3 * np.mean(steady):.3f}, "
          f"median {1e3 * np.median(steady):.3f}), train_s {trial['train_s']:.3f}, "
          f"layout_preprocess_s {trial['layout_preprocess_s']:.3f}, "
          f"{_peak_memory(held)}, "
          f"launches fwd {fwd} bwd {bwd}")
    return {"launches": fwd + bwd}


def _gat_cases(c, ct, heads, width, gen) -> dict:
    """Each GAT kernel, and K1 with runtime columns and weights, on ``heads`` heads
    and ``width`` features: ``{name: Case}``, each call returning a tuple of tensors.
    The inputs of K4 and K5 are the plain versions' own outputs, so that each kernel
    is checked alone. Operations count 8 per edge and head for K3 and K4 (adds,
    LeakyReLU, max or min, exp, divide), 4 for K5, 1 for K6, 2 per edge and feature
    for K1 (1 with unit weights); K7 only moves bytes. K1's bytes leave out what
    carries nothing: the identity columns (0..E-1) and the unit weights."""
    from dgll_tpu_torch.ops import gat_csr, spmm_chunked_reference
    from dgll_tpu_torch.ops.cuda import gat_fused as gf
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_csr_cuda

    nnz = c.src.numel()

    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    sc, sd = 2 * r(nnz, heads), 2 * r(c.n_rows, heads)
    m, den = gat_csr.gat_stats_reference(c, sc, sd)
    alpha, lgrad = gat_csr.gat_alpha_reference(c, sc, sd, m, den)
    dalpha, s_row, g = r(nnz, heads), r(c.n_rows, heads), r(c.n_rows, width)
    prod = alpha * dalpha
    msg, w = r(nnz, width), torch.rand(nnz, generator=gen, device="cuda")
    ids, ones, perm, offsets = c.edge_ids, ct.unit_weight, c.t_slot_perm, c.indptr.long()
    a_mat = csr(c.indptr, ids, w, (c.n_rows, nnz))
    t_mat = csr(ct.indptr, perm, ones, (ct.n_rows, nnz))
    return {
        "gat_stats": Case(lambda: gf.gat_stats_cuda(c, sc, sd),
                          lambda: gat_csr.gat_stats_reference(c, sc, sd),
                          None, (c.indptr, sc, sd), 8 * nnz * heads),
        "gat_alpha": Case(lambda: gf.gat_alpha_cuda(c, sc, sd, m, den),
                          lambda: gat_csr.gat_alpha_reference(c, sc, sd, m, den),
                          None, (c.rows, sc, sd, m, den), 8 * nnz * heads),
        "gat_bwd_softmax": Case(
            lambda: gf.gat_bwd_softmax_cuda(c, alpha, dalpha, lgrad, s_row),
            lambda: gat_csr.gat_bwd_softmax_reference(c, alpha, dalpha, lgrad, s_row),
            None, (c.indptr, alpha, dalpha, lgrad, s_row), 4 * nnz * heads),
        "edges_to_rows_sum": Case(
            lambda: (gf.edges_to_rows_sum_cuda(c, prod),),
            lambda: (gat_csr.edges_to_rows_sum_reference(c, prod),),
            lambda: torch.segment_reduce(prod, "sum", offsets=offsets),
            (c.indptr, prod), nnz * heads),
        "expand_rows": Case(lambda: (gf.expand_rows_cuda(c, g),),
                            lambda: (gat_csr.expand_rows_reference(c, g),),
                            lambda: g.index_select(0, c.rows), (c.rows, g), 0),
        "K1 identity columns, runtime weights, on A": Case(
            lambda: (spmm_csr_cuda(c, msg, cols=ids, weights=w),),
            lambda: (spmm_chunked_reference(c, msg, cols=ids, weights=w),),
            lambda: torch.sparse.mm(a_mat, msg), (c.indptr, w, msg),
            2 * nnz * width),
        "K1 t_slot_perm columns, unit weights, on A^T": Case(
            lambda: (spmm_csr_cuda(ct, msg, cols=perm, weights=ones),),
            lambda: (spmm_chunked_reference(ct, msg, cols=perm, weights=ones),),
            lambda: torch.sparse.mm(t_mat, msg), (ct.indptr, perm, msg),
            nnz * width),
    }


def _alpha_case(c, heads, gen, misaligned=False) -> tuple:
    """K4 on random scores with the plain K3's m and den of them: ``(Case, vec)``,
    ``vec`` the variant of the edge-major mapping its wrapper picks
    (``gat_fused.edge_plan``; the outputs come from the caching allocator, 16-byte
    aligned). ``misaligned`` puts the scores 4 bytes past a 16-byte boundary."""
    from dgll_tpu_torch.ops import gat_csr
    from dgll_tpu_torch.ops.cuda import gat_fused as gf

    nnz = c.src.numel()
    flat = 2 * torch.randn(nnz * heads + 1, generator=gen, device="cuda")
    sc = (flat[1:] if misaligned else flat[:-1]).view(nnz, heads)
    sd = 2 * torch.randn(c.n_rows, heads, generator=gen, device="cuda")
    m, den = gat_csr.gat_stats_reference(c, sc, sd)
    plan = gf.edge_plan(nnz, heads, c.rows, (sc,), (sd, m, den))
    return Case(lambda: gf.gat_alpha_cuda(c, sc, sd, m, den),
                lambda: gat_csr.gat_alpha_reference(c, sc, sd, m, den),
                None, (c.rows, sc, sd, m, den), 8 * nnz * heads), plan.vec


def _mapping_vec(heads, misaligned=False) -> int:
    """The variant the edge-major mapping must take: float4 units of 4 edges (H = 1)
    or 4 heads (H % 4 == 0) on aligned pointers, else an edge a unit."""
    return 4 if (heads == 1 or heads % 4 == 0) and not misaligned else 1


def phase_alpha_mapping(worst: dict, gen) -> None:
    """Phase 6: K4 on ``tail_layouts`` (every nnz % 4) at ``SPLIT_HEADS``, then on
    one of them at ``K4_MORE_HEADS`` and with misaligned scores at 1 and 8 heads:
    alpha within 1e-4 x max|ref|, lgrad exactly equal, bitwise repeatable, each in
    the variant it must take."""
    cases = [(rem, c, heads, False) for rem, c in tail_layouts().items()
             for heads in SPLIT_HEADS]
    rem, c = 2, tail_layouts()[2]
    cases += [(rem, c, heads, False) for heads in K4_MORE_HEADS]
    cases += [(rem, c, heads, True) for heads in (1, 8)]
    for rem, c, heads, misaligned in cases:
        case, vec = _alpha_case(c, heads, gen, misaligned)
        check(vec == _mapping_vec(heads, misaligned),
              f"K4's variant at H={heads} (misaligned {misaligned}): vec {vec}")
        tag = (f"nnz % 4 = {rem}, H={heads}{', misaligned' if misaligned else ''}, "
               f"vec {vec}")
        line, _ = _compare(tag, "gat_alpha", case, worst)
        print(f"[6 check] K4 {tag}: {line}")
    print(f"[6 check] K4: all {len(cases)} mapping cases pass (lgrad exactly equal)")


def _max_err(got, want, scale=1e-4) -> tuple:
    """(max abs error, scale * max|ref|). Rows without edges carry the row max
    NEG = -3e38 (K3's m, K6's max): they must match exactly and are left out of the
    bound."""
    from dgll_tpu_torch.ops.gat_csr import NEG

    edgeless = want == NEG
    check(torch.equal(got == NEG, edgeless), "rows without edges give NEG")
    got, want = torch.where(edgeless, 0.0, got), torch.where(edgeless, 0.0, want)
    return (got - want).abs().max().item(), scale * want.abs().max().item()


def _compare(tag, name, case, worst, scale=1e-4, exact=False) -> tuple:
    """Check one case (f32: every output within ``scale`` * max|ref| of the plain
    version's, or equal to it with ``exact``, and those of ``EXACT_OUTPUTS`` always;
    none of the kernels uses atomics, so two runs must be bitwise equal), keep its
    max abs error in ``worst`` under the kernel's JSON key, and return the printed
    summary and the kernel's outputs."""
    got, again, want = case.kernel(), case.kernel(), case.plain()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    errs = [_max_err(a, b, scale) for a, b in zip(got, want)]
    for i in range(len(got)) if exact else EXACT_OUTPUTS.get(name, ()):
        check(torch.equal(got[i], want[i]), f"{name} output {i} equals its plain "
                                            f"version's ({tag})")
    check(all(x <= b for x, b in errs),
          f"{name} within tolerance ({tag}): (max abs err, tolerance) {errs}")
    check(same, f"{name}: two runs bitwise equal ({tag})")
    key = K1_GAT if name.startswith("K1") else name
    worst[key] = max(worst.get(key, 0.0), *(x for x, _ in errs))
    line = ("exactly equal" if exact else "max abs err " + ", ".join(
        f"{x:.3e} (tolerance {b:.3e})" for x, b in errs))
    return f"{line}; bitwise repeatable {same}", got


def phase_gat_check(worst: dict, n=50_000, e=800_000) -> None:
    """Phase 6: the GAT kernels against their plain versions on the power-law test
    graph, H in {1, 8}; then K3, K5 and K6 on the planted graph whose rows cross the
    split threshold (T-1 .. 2T+1 and 60,000 edges), H in ``SPLIT_HEADS``; then K4's
    mapping cases (``phase_alpha_mapping``)."""
    c, ct, n = power_law_layouts(n, e)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for heads, width in ((1, 16), (8, 64)):
        for name, case in _gat_cases(c, ct, heads, width, gen).items():
            line, _ = _compare(f"H={heads}", name, case, worst)
            print(f"[6 check] H={heads} width={width} {name}: {line}")
    print(f"[6 check] {c.src.numel()} edges over {n} rows; A: {_split_summary(c)}; "
          f"A^T: {_split_summary(ct)}: all cases pass")
    c, ct, n = planted_layouts()
    for heads in SPLIT_HEADS:
        for name, case in _gat_cases(c, ct, heads, 16, gen).items():
            if name in SPLIT_GAT:
                line, _ = _compare(f"planted, H={heads}", name, case, worst)
                print(f"[6 check] planted H={heads} {name}: {line}")
    print(f"[6 check] planted: {c.src.numel()} edges over {n} rows; A: "
          f"{_split_summary(c)}: all K3, K5 and K6 cases pass")
    phase_alpha_mapping(worst, gen)


def phase_gat_layer() -> None:
    """Phase 7: the fused layer ``gat_attention_fused`` through autograd, forward and
    backward, against the plain composition ``gat_attention_coo`` at the slice's
    shapes (layer 1: 8 heads x 8 features with an attention-dropout mask; layer 2:
    1 head x 16 features); f32, bound 1e-4 * max|ref| on out, dh, da_src, da_dst."""
    from dgll_tpu_torch.ops import gat_attention_coo
    from dgll_tpu_torch.ops.cuda.gat_fused import gat_attention_fused

    c, ct, n = slice_graph()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for heads, f, p in ((8, 8, 0.6), (1, 16, 0.0)):
        h0 = torch.randn(n, heads * f, generator=gen, device="cuda")
        a0 = [0.3 * torch.randn(heads, f, generator=gen, device="cuda") for _ in range(2)]
        cot = torch.randn(c.n_rows, heads, f, generator=gen, device="cuda")
        mask = None
        if p:
            keep = torch.rand(c.src.numel(), heads, generator=gen, device="cuda") >= p
            mask = keep.float() / (1 - p)

        def grads(fn):
            h, a_src, a_dst = (t.clone().requires_grad_(True) for t in (h0, *a0))
            out = fn(h, a_src, a_dst)
            (out * cot).sum().backward()
            return out.detach(), h.grad, a_src.grad, a_dst.grad

        got = grads(lambda h, s, d: gat_attention_fused(c, ct, h, s, d, 0.2, mask))
        want = grads(lambda h, s, d: gat_attention_coo(c.src, c.rows, h, s, d, c.n_rows,
                                                       0.2, mask))
        for name, a, b in zip(("out", "dh", "da_src", "da_dst"), got, want):
            err, tol = (a - b).abs().max().item(), 1e-4 * b.abs().max().item()
            print(f"[7 layer] H={heads} F={f} dropout {p} {name} {tuple(a.shape)}: "
                  f"max abs err {err:.3e}, tolerance {tol:.3e}")
            check(err <= tol, f"fused layer within tolerance (H={heads}, {name})")


def phase_gat_time(worst: dict) -> dict:
    """Phase 8: each GAT kernel against its plain version at the slice's shapes,
    checked as in phase 6 and then timed beside its plain version, its library call
    and its bound. Returns {name: times} at layer 1's shapes (8 heads, width 64)."""
    c, ct, _ = slice_graph()
    gen = torch.Generator(device="cuda").manual_seed(4)
    result = {}
    for heads, width in ((8, 64), (1, 16)):
        for name, case in _gat_cases(c, ct, heads, width, gen).items():
            line, outs = _compare(f"slice, H={heads}", name, case, worst)
            t = timed(case, outs)
            print(f"[8 time] H={heads} width={width} {name}: {describe(t)}; {line}")
            if heads == 8 and name != "K1 t_slot_perm columns, unit weights, on A^T":
                result[K1_GAT if name.startswith("K1") else name] = t
    return result


def phase_gat_slice() -> dict:
    """Phase 9: the GAT slice, 20 epochs through ``run.main``. Returns the launch
    counts of the run, per kernel."""
    from dgll_tpu_torch import run
    from dgll_tpu_torch.ops.cuda import gat_fused as gf
    from dgll_tpu_torch.ops.cuda import segment_matmul as sm
    from dgll_tpu_torch.tools.profile_slice import GAT_SLICE_ARGS

    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for k in gf.launches:
        gf.launches[k] = 0
    sm.launches_fwd = sm.launches_bwd = 0
    with contextlib.redirect_stdout(io.StringIO()):  # the CLI's own JSON line
        out = run.main([*GAT_SLICE_ARGS, "--n_epochs", str(EPOCHS)])
    counts = {**gf.launches, K1_GAT: sm.launches_fwd + sm.launches_bwd}
    fwd, bwd = sm.launches_fwd, sm.launches_bwd
    trial = out["trials"][0]
    losses, secs, epochs = trial["epoch_loss"], trial["epoch_s"], trial["epochs"]
    check(epochs == EPOCHS, f"{EPOCHS} epochs ran")
    check(all(np.isfinite(losses)), "every loss is finite")
    check(losses[-1] < losses[0], "the last loss is below the first")
    check(trial["test_acc"] > 2 / 16, "test_acc above 2/16")
    check(trial.get("gat_kernel") == run.GAT_KERNEL, "the slice names the fused GAT op")
    # two layers: forward kernels at least twice per epoch (the validation pass
    # runs the forward too), backward kernels exactly twice per epoch
    for k in ("gat_stats", "gat_alpha"):
        check(counts[k] >= 2 * epochs, f"at least 2 {k} launches per epoch")
    for k in ("gat_bwd_softmax", "edges_to_rows_sum", "expand_rows"):
        check(counts[k] == 2 * epochs, f"exactly 2 {k} launches per epoch")
    check(fwd >= 2 * epochs and bwd == 2 * epochs, "K1: >= 2 forward and 2 backward "
          "launches per epoch")
    steady = secs[1:]
    print(f"[9 gat slice] {epochs} epochs: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"test_acc {trial['test_acc']:.4f}, epoch ms mean {1e3 * np.mean(secs):.3f} "
          f"(first {1e3 * secs[0]:.3f}, rest mean {1e3 * np.mean(steady):.3f}, "
          f"median {1e3 * np.median(steady):.3f}), train_s {trial['train_s']:.3f}, "
          f"layout_preprocess_s {trial['layout_preprocess_s']:.3f}, "
          f"{_peak_memory(held)}, "
          f"launches {counts} (K1 fwd {fwd} bwd {bwd})")
    summary = {"test_acc": trial["test_acc"], "epoch_ms_median": 1e3 * np.median(steady),
               "peak_gib": (torch.cuda.max_memory_allocated() - held) / 2**30}
    return counts, summary


@functools.cache
def clustered_layouts(n=50_000, empty_block=False):
    """The hybrid layouts of A and A^T on the card for the bench's clustered
    generator at ``n`` nodes; with ``empty_block``, the edges into and out of one
    128-row block in the middle removed."""
    from dgll_tpu_torch.bench import clustered_graph
    from dgll_tpu_torch.data import gcn_normalize
    from dgll_tpu_torch.ops.windowed import build_hybrid_pair

    g = gcn_normalize(clustered_graph(n, 16))
    src, dst, w = g.src.numpy(), g.dst.numpy(), g.edge_weight.numpy()
    if empty_block:
        lo = n // 2 // 128 * 128
        keep = ~(((dst >= lo) & (dst < lo + 128)) | ((src >= lo) & (src < lo + 128)))
        src, dst, w = src[keep], dst[keep], w[keep]
    h, ht = build_hybrid_pair(src, dst, n, n, w)
    return h.to("cuda"), ht.to("cuda"), n


def _windowed_case(c, f, dtype, activation, gen):
    """K2 against its plain version on the same (quantised) inputs: returns the max
    abs error, its ratio to the case's bound (f32 sums: 1e-5 * max|ref|; bf16
    output: |err| / max(|ref|, 1) against 1e-2) and whether two runs were bitwise
    equal. bf16 input without activation is stored in f32, as the hybrid op does."""
    from dgll_tpu_torch.ops.cuda.spmm_windowed import spmm_windowed_cuda
    from dgll_tpu_torch.ops.windowed import spmm_windowed_reference

    x = torch.randn(c.n_cols, f, generator=gen, device="cuda").to(dtype)
    b = torch.randn(f, generator=gen, device="cuda") if activation else None
    out_dtype = torch.float32 if dtype == torch.bfloat16 and activation is None else dtype
    out = spmm_windowed_cuda(c, x, b, activation, out_dtype)
    again = spmm_windowed_cuda(c, x, b, activation, out_dtype)
    ref = spmm_windowed_reference(c, x.float(), b, activation)
    torch.cuda.synchronize()
    check(out.shape == (c.n_rows, f) and out.dtype == out_dtype, "K2's output shape, dtype")
    diff = (out.float() - ref).abs()
    if out_dtype == torch.float32:
        ratio = (diff.max() / (1e-5 * ref.abs().max())).item()
    else:
        ratio = ((diff / ref.abs().clamp_min(1.0)).max() / 1e-2).item()
    return diff.max().item(), ratio, torch.equal(out, again), out, b


# sub-chunks per row block of the ring graph (phase 10): none, fewer than, as many
# as and more than K2's 3 stages, odd and even, up to several turns of the ring
RING_SUBS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 13, 17)


@functools.cache
def ring_layout(seed=10):
    """A windowed layout whose row block b has exactly ``RING_SUBS[b]`` sub-chunks:
    sub-chunk i of a block has 100 edges from rows [512 i, 512 i + 100) of x (one
    window each) into random rows of the block. On the card."""
    from dgll_tpu_torch.ops.windowed import WIN_ROWS, build_windowed

    rng = np.random.default_rng(seed)
    src, dst = [], []
    for b, k in enumerate(RING_SUBS):
        for i in range(k):
            src.append(WIN_ROWS * i + rng.permutation(100))
            dst.append(128 * b + rng.integers(0, 128, 100))
    src, dst = np.concatenate(src), np.concatenate(dst)
    n_cols = WIN_ROWS * max(RING_SUBS)
    w = rng.random(len(src)).astype(np.float32)
    win, resid = build_windowed(src, dst, 128 * len(RING_SUBS), n_cols, w)
    check(resid is None, "the ring graph has no residual edges")
    check(np.array_equal(np.diff(win.blk_ptr.numpy()), RING_SUBS),
          f"sub-chunks per row block {RING_SUBS}")
    return win.to("cuda")


def phase_windowed_check() -> float:
    """Phase 10: K2 against ``spmm_windowed_reference`` on the clustered test graph
    (A: F in {16, 128, 256}, f32 and bf16, with and without bias + ReLU; A^T at
    F=128), on the ring graph (``RING_SUBS`` sub-chunks a row block, so that K2's
    ring of stages runs empty, part full, full and wraps) and on a graph with an
    empty row block, whose rows must come out as act(bias) exactly. Returns the max
    abs error of the f32 cases."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    h, ht, n = clustered_layouts()
    worst = 0.0
    cases = [("A", h.win, f, dt, act) for f in (16, 128, 256)
             for dt in (torch.float32, torch.bfloat16) for act in (None, "relu")]
    cases.append(("A^T", ht.win, 128, torch.float32, "relu"))
    for name, c, f, dt, act in cases:
        err, ratio, same, _, _ = _windowed_case(c, f, dt, act, gen)
        print(f"[10 check] {name} F={f} {str(dt)[6:]} act={act}: max abs err {err:.3e}; "
              f"{ratio:.3f} of tolerance; bitwise repeatable {same}")
        check(ratio <= 1.0, f"K2 within tolerance ({name}, F={f}, {dt}, {act})")
        check(same, f"K2: two runs bitwise equal ({name}, F={f}, {dt}, {act})")
        if dt == torch.float32:
            worst = max(worst, err)
    print(f"[10 check] {h.win.src.numel()} windowed "
          f"edges in {h.win.n_sub} sub-chunks over {n} rows, windowed fraction "
          f"{h.windowed_fraction:.4f}: {len(cases)} cases pass")

    ring = ring_layout()
    for f, dt in ((128, torch.float32), (128, torch.bfloat16), (16, torch.float32)):
        for act in (None, "relu"):
            err, ratio, same, _, _ = _windowed_case(ring, f, dt, act, gen)
            check(ratio <= 1.0 and same, f"K2 on the ring graph (F={f}, {dt}, {act}): "
                                         f"{ratio:.3f} of tolerance, repeatable {same}")
            if dt == torch.float32:
                worst = max(worst, err)
    print(f"[10 check] ring graph, {RING_SUBS} sub-chunks a row block: F=128 f32 and "
          f"bf16, F=16 f32, with and without bias + ReLU, within tolerance and bitwise "
          f"repeatable")

    eh, _, _ = clustered_layouts(empty_block=True)
    blk_ptr = eh.win.blk_ptr.cpu()
    lo = n // 2 // 128
    check(bool(blk_ptr[lo] == blk_ptr[lo + 1]), "the empty row block has no sub-chunk")
    err, ratio, same, out, b = _windowed_case(eh.win, 128, torch.float32, "relu", gen)
    rows = out[lo * 128:(lo + 1) * 128]
    exact = torch.equal(rows, torch.relu(b).expand_as(rows))
    print(f"[10 check] empty row block: max abs err {err:.3e}; {ratio:.3f} of tolerance; "
          f"bitwise repeatable {same}; its rows equal relu(bias) {exact}")
    check(ratio <= 1.0 and same and exact, "K2 on the graph with an empty row block")
    return max(worst, err)


def _bench_graph():
    """The bench's clustered graph at 200k nodes, with both layouts on the card."""
    from dgll_tpu_torch.bench import clustered_graph
    from dgll_tpu_torch.data import gcn_normalize

    return gcn_normalize(clustered_graph(200_000, 16)).with_windowed().with_chunked().to("cuda")


def phase_hybrid() -> dict:
    """Phase 11: ``spmm_hybrid`` forward and backward through autograd at the
    bench's shapes (F=128; without bias, as the GCN layer calls it, and with bias +
    ReLU) against the plain composition, f32 within 1e-5 * max|ref| on out, dx, db;
    then K2 and its plain version, the hybrid op's forward and K1 over the whole
    graph (its chunked layout) and its plain version, timed with CUDA events on A
    and A^T. Returns the times and the max abs error."""
    from dgll_tpu_torch.ops import spmm_chunked_reference
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_csr_cuda
    from dgll_tpu_torch.ops.cuda.spmm_windowed import (
        hybrid_forward,
        spmm_hybrid,
        spmm_windowed_cuda,
    )
    from dgll_tpu_torch.ops.windowed import spmm_windowed_reference
    from dgll_tpu_torch.utils.profiling import cuda_median_ms

    g = _bench_graph()
    h, ht, n, f = g.hybrid, g.hybrid_t, g.n_node, 128
    check(h is not None and h.res is not None, "the bench graph carries the hybrid layout")
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    for act in (None, "relu"):
        x0 = torch.randn(n, f, generator=gen, device="cuda")
        b0 = torch.randn(f, generator=gen, device="cuda") if act else None
        cot = torch.randn(h.win.n_rows, f, generator=gen, device="cuda")
        x = x0.clone().requires_grad_(True)
        b = None if b0 is None else b0.clone().requires_grad_(True)
        out = spmm_hybrid(h, ht, x, b, act)
        (out * cot).sum().backward()
        xr = x0.clone().requires_grad_(True)
        br = None if b0 is None else b0.clone().requires_grad_(True)
        pre = (spmm_windowed_reference(h.win, xr)
               + spmm_chunked_reference(h.res, xr, out_dtype=torch.float32))
        if br is not None:
            pre = pre + br
        ref = torch.relu(pre) if act else pre
        # the ReLU gate of the backward is the op's own forward
        gated = torch.where(out > 0, pre, 0.0) if act else pre
        (gated * cot).sum().backward()
        pairs = [("out", out.detach(), ref.detach()), ("dx", x.grad, xr.grad)]
        if b is not None:
            pairs.append(("db", b.grad, br.grad))
        for name, got, want in pairs:
            err, tol = (got - want).abs().max().item(), 1e-5 * want.abs().max().item()
            print(f"[11 hybrid] act={act} {name} {tuple(got.shape)}: max abs err "
                  f"{err:.3e}, tolerance {tol:.3e}")
            check(err <= tol, f"spmm_hybrid within tolerance (act={act}, {name})")
            worst = max(worst, err)

    times = {}
    for name, hy, c in (("A", h, g.chunked), ("A^T", ht, g.chunked_t)):
        x = torch.randn(c.n_cols, f, generator=gen, device="cuda")
        w = hy.win
        # the library call: torch.sparse.mm over the windowed edges' matrix
        w_mat = torch.sparse_coo_tensor(torch.stack([w.rows.long(), w.src.long()]),
                                        w.weight, (w.n_rows, w.n_cols)).coalesce()
        w_mat = w_mat.to_sparse_csr()
        k2_bound = bound(nbytes(w.blk_ptr, w.sub_ptr, w.sub_x0, w.sub_nx, w.src, w.rows,
                                w.weight, x) + w.n_rows * f * 4, 2 * w.src.numel() * f)
        times[name] = {
            "K2": cuda_median_ms(lambda: spmm_windowed_cuda(hy.win, x)),
            "K2 plain": cuda_median_ms(lambda: spmm_windowed_reference(hy.win, x)),
            "K2 library": cuda_median_ms(lambda: torch.sparse.mm(w_mat, x)),
            "K2 bound": k2_bound[0],
            "hybrid": cuda_median_ms(lambda: hybrid_forward(hy, x, None, None, torch.float32)),
            "hybrid plain": cuda_median_ms(lambda: (
                spmm_windowed_reference(hy.win, x)
                + spmm_chunked_reference(hy.res, x, out_dtype=torch.float32))),
            "K1 whole graph": cuda_median_ms(lambda: spmm_csr_cuda(c, x)),
            "K1 plain": cuda_median_ms(lambda: spmm_chunked_reference(c, x)),
        }
        staged = int(hy.win.sub_nx.sum())
        times[name]["K2 bound_by"] = k2_bound[1]
        print(f"[11 time] F={f} {name}: " + ", ".join(
            f"{k} {v:.4f} ms" if isinstance(v, float) else f"{k} {v}"
            for k, v in times[name].items())
            + f"; {hy.win.src.numel()} windowed edges in {hy.win.n_sub} sub-chunks "
            f"staging {staged} rows, {hy.res.src.numel()} residual edges, "
            f"windowed fraction {hy.windowed_fraction:.4f}")
    del g
    return {"times": times, "err": worst}


def phase_bench() -> dict:
    """Phase 12: the bench's full-graph GCN step (``dgll_tpu_torch.bench``) on the
    clustered graph at 200k nodes, through K2 and K1 on the residual, then through
    K1 alone. Returns the two results."""
    from dgll_tpu_torch import bench

    res = {}
    for layout in ("auto", "chunked"):
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r = bench.fullgraph_step("cuda", layout)
        steps, k = r["steps"], r["launches"]
        losses = r["losses"]
        check(steps == 14 and all(np.isfinite(losses)), "14 steps, every loss finite")
        check(losses[-1] < losses[0], "the last loss is below the first")
        check(k["k1_fwd"] == k["k1_bwd"] == 2 * steps, "2 K1 launches a step each way")
        if layout == "auto":
            check(r["kernel"] == "windowed_hybrid", "the bench ran the windowed layout")
            check(abs(r["windowed_fraction"] - BENCH_FRACTION) <= 1e-3,
                  f"windowed_fraction within 1e-3 of {BENCH_FRACTION}")
            check(k["k2_fwd"] == k["k2_bwd"] == 2 * steps, "2 K2 launches a step each way")
        else:
            check(r["kernel"] == "classic_chunked", "the bench ran K1 alone")
            check(k["k2_fwd"] == k["k2_bwd"] == 0, "no K2 launch with the chunked layout")
        print(f"[12 bench] layout {layout}: kernel {r['kernel']}, step_ms "
              f"{r['step_ms']:.4f}, windowed_fraction {r['windowed_fraction']:.4f}, "
              f"pad_factor {r['pad_factor']:.4f}, roofline_fraction "
              f"{r['roofline_fraction']:.4f} of {r['roofline_gbps']} GB/s, "
              f"edges/s/layer pass {r['edges_per_s_per_layerpass']}, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}, layout_preprocess_s "
              f"{r['layout_preprocess_s']:.3f}, {_peak_memory(held)}, launches {k}")
        res[layout] = r
    return res


def _r4_cases(c, heads, width, gen) -> dict:
    """The round-4 path's kernels on ``heads`` heads and ``width`` features, keyed by
    their JSON counters: ``{name: (Case, scale)}``: 0 for the maxima and the copies,
    which must equal their plain versions; 1e-5 * max|ref| for K9; 1e-4 * max|ref|
    for the sums, the bar phase 6 holds K6's sum kernel to (the plain version's
    ``index_add`` sums in another order, and a hub row has tens of thousands of
    edges). At one head the single-head K10 launchers are added. K9 reads ``msg =
    x[src]``, as both its callers have it, so that its library call is
    ``sampled_addmm`` over A's pattern with ``x``. Operations count 1 per edge and
    head for the reductions and 2 per edge and feature for K9; the copies only move
    bytes."""
    from dgll_tpu_torch.ops import gat_csr
    from dgll_tpu_torch.ops.cuda import edge_ops as tk
    from dgll_tpu_torch.ops.cuda import gat_fused as gf

    nnz = c.src.numel()

    def r(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    v, s = r(nnz, heads), r(c.n_rows, heads)
    a, x = r(c.n_rows, width), r(c.n_cols, width)
    msg, xt, offsets = x.index_select(0, c.src), x.t().contiguous(), c.indptr.long()
    pattern = csr(c.indptr, c.src, torch.zeros(nnz, device="cuda"), (c.n_rows, c.n_cols))
    cases = {
        "edges_to_rows_max": (Case(
            lambda: (tk.edges_to_rows_max_cuda(c, v),),
            lambda: (gat_csr.edges_to_rows_max_reference(c, v),),
            lambda: torch.segment_reduce(v, "max", offsets=offsets),
            (c.indptr, v), nnz * heads), 0),
        "sum_all": (Case(
            lambda: (gf.edges_to_rows_sum_cuda(c, v),),
            lambda: (gat_csr.edges_to_rows_sum_reference(c, v),),
            lambda: torch.segment_reduce(v, "sum", offsets=offsets),
            (c.indptr, v), nnz * heads), 1e-4),
        "rows_to_edges_multi": (Case(
            lambda: (tk.rows_to_edges_multi_cuda(c, s),),
            lambda: (gat_csr.rows_to_edges_reference(c, s),),
            lambda: s.index_select(0, c.rows), (c.rows, s), 0), 0),
        "sddmm_edges": (Case(
            lambda: (tk.sddmm_cuda(c, a, msg),),
            lambda: (gat_csr.sddmm_reference(c, a, msg),),
            lambda: torch.sparse.sampled_addmm(pattern, a, xt, beta=0.0),
            (c.rows, a, msg), 2 * nnz * width), 1e-5),
    }
    if heads == 1:
        v1, s1 = v[:, 0].contiguous(), s[:, 0].contiguous()
        cases["rows_to_edges"] = (Case(
            lambda: (tk.rows_to_edges_cuda(c, s1),),
            lambda: (gat_csr.rows_to_edges_reference(c, s1),),
            lambda: s1.index_select(0, c.rows), (c.rows, s1), 0), 0)
        cases["edges_to_rows:sum"] = (Case(
            lambda: (tk.edges_to_rows_cuda(c, v1, "sum"),),
            lambda: (gat_csr.edges_to_rows_sum_reference(c, v1),),
            lambda: torch.segment_reduce(v1, "sum", offsets=offsets),
            (c.indptr, v1), nnz), 1e-4)
        cases["edges_to_rows:max"] = (Case(
            lambda: (tk.edges_to_rows_cuda(c, v1, "max"),),
            lambda: (gat_csr.edges_to_rows_max_reference(c, v1),),
            lambda: torch.segment_reduce(v1, "max", offsets=offsets),
            (c.indptr, v1), nnz), 0)
    return cases


def phase_r4_check(worst: dict, n=50_000, e=800_000) -> None:
    """Phase 13: the round-4 path's kernels against their plain versions on the
    power-law test graph (hub rows, an edgeless 128-row block), H in {1, 8} and F in
    {16, 64}: maxima and copies exactly equal, K9 within 1e-5 and the sums within
    1e-4 of max|ref|, and every kernel bitwise repeatable; then K6's max and sum_all
    and K10's two launchers (H=1) on the planted graph whose rows cross the split
    threshold, H in ``SPLIT_HEADS``, K10's rows-to-edges at the edge counts of
    ``R2E_TAILS``, and K6′ on ``tail_layouts`` at ``R2E_MULTI_HEADS``."""
    c, ct, n = power_law_layouts(n, e)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for heads, width in ((1, 16), (8, 64)):
        for name, (case, scale) in _r4_cases(c, heads, width, gen).items():
            line, _ = _compare(f"H={heads}", name, case, worst, scale, scale == 0)
            print(f"[13 check] H={heads} F={width} {name}: {line}")
    print(f"[13 check] {c.src.numel()} edges over {n} rows, max in-degree "
          f"{int((c.indptr[1:] - c.indptr[:-1]).max())}: all cases pass")
    c, ct, n = planted_layouts()
    for heads in SPLIT_HEADS:
        for name, (case, scale) in _r4_cases(c, heads, 16, gen).items():
            if name in SPLIT_R4:
                line, _ = _compare(f"planted, H={heads}", name, case, worst, scale,
                                   scale == 0)
                print(f"[13 check] planted H={heads} {name}: {line}")
    print(f"[13 check] planted: {c.src.numel()} edges over {n} rows; A: "
          f"{_split_summary(c)}: all K6 and K10 cases pass")
    _rows_to_edges_tails(worst, gen)
    _rows_to_edges_multi_tails(worst, gen)


def _rows_to_edges_multi_tails(worst: dict, gen) -> None:
    """Phase 13: K6′ on ``tail_layouts`` (every nnz % 4) at ``R2E_MULTI_HEADS``, and
    on one of them with a misaligned ``v`` at 8 heads (an edge a unit); exactly
    equal, bitwise repeatable."""
    from dgll_tpu_torch.ops import gat_csr
    from dgll_tpu_torch.ops.cuda import edge_ops as tk
    from dgll_tpu_torch.ops.cuda import gat_fused as gf

    cases = [(rem, c, heads, False) for rem, c in tail_layouts().items()
             for heads in R2E_MULTI_HEADS]
    cases.append((2, tail_layouts()[2], 8, True))
    for rem, c, heads, misaligned in cases:
        flat = torch.randn(c.n_rows * heads + 1, generator=gen, device="cuda")
        s = (flat[1:] if misaligned else flat[:-1]).view(c.n_rows, heads)
        vec = gf.edge_plan(c.src.numel(), heads, c.rows, (), (s,)).vec
        check(vec == _mapping_vec(heads, misaligned),
              f"K6′'s variant at H={heads} (misaligned {misaligned}): vec {vec}")
        case = Case(lambda: (tk.rows_to_edges_multi_cuda(c, s),),
                    lambda: (gat_csr.rows_to_edges_reference(c, s),), None, (), 0)
        _compare(f"nnz % 4 = {rem}, H={heads}, vec {vec}", "rows_to_edges_multi", case,
                 worst, 0, True)
    print(f"[13 check] rows_to_edges_multi (K6′) in {len(cases)} cases, nnz % 4 = 0-3, "
          f"H in {R2E_MULTI_HEADS}, and misaligned at H=8: exactly equal, bitwise "
          f"repeatable")


def _rows_to_edges_tails(worst: dict, gen, n=1000) -> None:
    """Phase 13: K10's rows-to-edges on random layouts of ``R2E_TAILS`` edges over
    ``n`` nodes: the last nnz % 4 edges, which the kernel's groups of 4 leave to the
    first block, and layouts with no whole group; exactly equal, bitwise
    repeatable."""
    from dgll_tpu_torch.ops import gat_csr
    from dgll_tpu_torch.ops.chunked import build_chunked
    from dgll_tpu_torch.ops.cuda import edge_ops as tk

    rng = np.random.default_rng(13)
    for nnz in R2E_TAILS:
        c = build_chunked(rng.integers(0, n, nnz), rng.integers(0, n, nnz), n, n).to("cuda")
        check(c.src.numel() == nnz, f"a layout of {nnz} edges")
        s = torch.randn(c.n_rows, generator=gen, device="cuda")
        case = Case(lambda: (tk.rows_to_edges_cuda(c, s),),
                    lambda: (gat_csr.rows_to_edges_reference(c, s),), None, (), 0)
        _compare(f"nnz={nnz}", "rows_to_edges", case, worst, 0, True)
    print(f"[13 check] rows_to_edges at {len(R2E_TAILS)} edge counts "
          f"{R2E_TAILS} (nnz % 4 = 0-3): exactly equal, bitwise repeatable")


def _counters() -> dict:
    """Every launch counter of the attention paths: ``edge_ops.launches``,
    ``gat_fused.launches`` (K6's sum kernel at H heads is its ``edges_to_rows_sum``)
    and K1's, as "K1 fwd" and "K1 bwd"."""
    from dgll_tpu_torch.ops.cuda import edge_ops as tk
    from dgll_tpu_torch.ops.cuda import gat_fused as gf
    from dgll_tpu_torch.ops.cuda import segment_matmul as sm

    return {**tk.launches, **gf.launches, "K1 fwd": sm.launches_fwd,
            "K1 bwd": sm.launches_bwd, "K1 bf16 route": sm.launches_bf16}


def _zero_counters() -> None:
    from dgll_tpu_torch.ops.cuda import edge_ops as tk
    from dgll_tpu_torch.ops.cuda import gat_fused as gf
    from dgll_tpu_torch.ops.cuda import segment_matmul as sm

    for counts in (tk.launches, gf.launches):
        for k in counts:
            counts[k] = 0
    sm.launches_fwd = sm.launches_bwd = sm.launches_bf16 = 0


# the launches of one forward and one backward of each round-4 layer; every other
# counter stays at 0 (the max passes no gradient, so its broadcast has no VJP)
R4_LAUNCHES = {
    "multihead": ({"rows_to_edges_multi": 3, "edges_to_rows_max": 1,
                   "edges_to_rows_sum": 1, "K1 fwd": 1},
                  {"edges_to_rows_sum": 2, "rows_to_edges_multi": 1, "expand_rows": 1,
                   "K1 bwd": 1}),
    "single": ({"rows_to_edges": 3, "edges_to_rows:max": 1, "edges_to_rows:sum": 1,
                "K1 fwd": 1},
               {"edges_to_rows:sum": 2, "rows_to_edges": 1, "expand_rows": 1,
                "sddmm_edges": 1, "K1 bwd": 1}),
}


def _layer_inputs(n, c, heads, f, gen):
    shape = (heads, f) if heads > 1 else (f,)
    h = torch.randn(n, heads * f, generator=gen, device="cuda")
    a = [0.3 * torch.randn(*shape, generator=gen, device="cuda") for _ in range(2)]
    cot = torch.randn(c.n_rows, heads, f, generator=gen, device="cuda")
    return h, a[0], a[1], cot


def _round4(c, ct, heads, f):
    """The round-4 layer of ``heads`` heads as a function of (h, a_src, a_dst) with
    the fused op's output shape, and the fused op itself."""
    from dgll_tpu_torch.ops import (
        gat_attention_chunked,
        gat_attention_chunked_fused,
        gat_attention_chunked_multihead,
    )

    layer = gat_attention_chunked_multihead if heads > 1 else gat_attention_chunked
    return (lambda h, s, d: layer(c, ct, h, s, d, 0.2).view(c.n_rows, heads, f),
            lambda h, s, d: gat_attention_chunked_fused(c, ct, h, s.view(heads, f),
                                                        d.view(heads, f), 0.2))


def phase_r4_layers() -> dict:
    """Phase 14: the round-4 layers at the GAT slice's widths on its 200k-node graph:
    ``gat_attention_chunked_multihead`` (8 heads x 8 features) and
    ``gat_attention_chunked`` (one head, F=16 and F=64), forward and backward in h,
    a_src and a_dst, each run with the counters set to 0 just before it and checked
    against ``R4_LAUNCHES`` just after; then the fused op at the same inputs (the
    same function): out within 1e-5 * max|ref|, gradients within 1e-4 * max|ref|.
    Returns the launches per JSON counter over the three runs ("sum_all": K6's sum
    kernel in the multi-head backward)."""
    c, ct, n = slice_graph()
    gen = torch.Generator(device="cuda").manual_seed(8)
    launches = collections.Counter()
    for heads, f in ((8, 8), (1, 16), (1, 64)):
        kind = "multihead" if heads > 1 else "single"
        h0, s0, d0, cot = _layer_inputs(n, c, heads, f, gen)
        round4, fused = _round4(c, ct, heads, f)
        runs = []
        for fn in (round4, fused):
            h, a_src, a_dst = (t.clone().requires_grad_(True) for t in (h0, s0, d0))
            _zero_counters()
            out = fn(h, a_src, a_dst)
            fwd = _counters()
            (out * cot).sum().backward()
            total = _counters()
            runs.append(((out.detach(), h.grad, a_src.grad, a_dst.grad), fwd, total))
        (got, fwd, total), (want, _, _) = runs
        bwd = {k: total[k] - fwd[k] for k in total}
        for step, counts, expected in zip(("forward", "backward"), (fwd, bwd),
                                          R4_LAUNCHES[kind]):
            check(counts == {k: expected.get(k, 0) for k in counts},
                  f"{kind} {step} launches {expected}, got "
                  f"{ {k: v for k, v in counts.items() if v} }")
        launches.update({k: total[k] for k in R4_LAUNCH_KEYS})
        launches["sum_all"] += bwd["edges_to_rows_sum"]
        for name, a, b in zip(("out", "dh", "da_src", "da_dst"), got, want):
            scale = 1e-5 if name == "out" else 1e-4
            err, tol = (a - b).abs().max().item(), scale * b.abs().max().item()
            print(f"[14 layers] {kind} H={heads} F={f} {name} {tuple(a.shape)}: max abs "
                  f"err {err:.3e} against the fused op, tolerance {tol:.3e}")
            check(err <= tol, f"round-4 {kind} layer within tolerance (F={f}, {name})")
        print(f"[14 layers] {kind} H={heads} F={f}: launches forward "
              f"{ {k: v for k, v in fwd.items() if v} }, backward "
              f"{ {k: v for k, v in bwd.items() if v} }")
    return dict(launches)


# the JSON counters that phase 14 reads from edge_ops.launches
R4_LAUNCH_KEYS = ("edges_to_rows_max", "rows_to_edges_multi", "rows_to_edges",
                  "edges_to_rows:sum", "edges_to_rows:max", "sddmm_edges")
# the shapes of the main path at which each round-4 kernel's JSON times are taken:
# (heads, width) of the multi-head layer or of the single-head output layer
R4_SHAPES = {"edges_to_rows_max": (8, 64), "sum_all": (8, 64),
             "rows_to_edges_multi": (8, 64), "rows_to_edges": (1, 16),
             "edges_to_rows:sum": (1, 16), "edges_to_rows:max": (1, 16),
             "sddmm_edges": (1, 16)}


def phase_r4_time(worst: dict) -> dict:
    """Phase 15: the round-4 kernels at the slice's shapes (checked as in phase 13,
    then timed beside their plain versions, library calls and bounds; K9 also at
    F=64), and both layers against the fused op: forward and forward + backward
    (median of 15 CUDA-event timings after 3 warm-ups, in the order round-4, fused,
    fused, round-4, each version's two medians averaged) and the peak memory of a
    forward + backward. Returns {"kernels": {name: times}, "layers": [...]}."""
    from dgll_tpu_torch.utils.profiling import cuda_median_ms

    c, ct, n = slice_graph()
    gen = torch.Generator(device="cuda").manual_seed(9)
    kernels = {}
    for heads, width in ((8, 64), (1, 16), (1, 64)):
        for name, (case, scale) in _r4_cases(c, heads, width, gen).items():
            if (heads, width) == (1, 64) and name != "sddmm_edges":
                continue
            line, outs = _compare(f"slice, H={heads}", name, case, worst, scale, scale == 0)
            t = timed(case, outs)
            print(f"[15 time] H={heads} F={width} {name}: {describe(t)}; {line}")
            if R4_SHAPES[name] == (heads, width):
                kernels[name] = t

    layers = []
    for heads, f in ((8, 8), (1, 16)):
        h0, s0, d0, cot = _layer_inputs(n, c, heads, f, gen)
        h, a_src, a_dst = (t.requires_grad_(True) for t in (h0, s0, d0))
        row = {"heads": heads, "F": f}
        for label, fn in zip(("round4", "fused"), _round4(c, ct, heads, f)):
            def fwd(fn=fn):
                with torch.no_grad():
                    return fn(h, a_src, a_dst)

            def fwd_bwd(fn=fn):
                return torch.autograd.grad((fn(h, a_src, a_dst) * cot).sum(),
                                           (h, a_src, a_dst))

            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fwd_bwd()
            torch.cuda.synchronize()
            row[f"{label}_peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
            row[label] = (fwd, fwd_bwd)
        for key in ("fwd_ms", "fwd_bwd_ms"):
            i = key == "fwd_bwd_ms"
            ms = [cuda_median_ms(row[label][i])
                  for label in ("round4", "fused", "fused", "round4")]
            row[f"round4_{key}"] = (ms[0] + ms[3]) / 2
            row[f"fused_{key}"] = (ms[1] + ms[2]) / 2
        del row["round4"], row["fused"]
        print(f"[15 layers] H={heads} F={f}: round-4 fwd {row['round4_fwd_ms']:.4f} ms, "
              f"fwd+bwd {row['round4_fwd_bwd_ms']:.4f} ms, peak "
              f"{row['round4_peak_gib']:.2f} GiB; fused fwd {row['fused_fwd_ms']:.4f} ms, "
              f"fwd+bwd {row['fused_fwd_bwd_ms']:.4f} ms, peak "
              f"{row['fused_peak_gib']:.2f} GiB (peaks above the script's held memory)")
        layers.append(row)
    return {"kernels": kernels, "layers": layers}


def _quantize_inputs(n, d, gen, aligned=True):
    """``x [n, d]`` (normal, std 2, column 3 all zero), on the card; unaligned: a view
    4 bytes into its buffer, so that K8 takes its scalar path."""
    buf = torch.empty(n * d + (0 if aligned else 1), device="cuda")
    x = buf[(0 if aligned else 1):].view(n, d)
    x.copy_(2.0 * torch.randn(n, d, generator=gen, device="cuda"))
    if d > 3:
        x[:, 3] = 0.0
    return x


def phase_quantize_check() -> float:
    """Phase 16: K8 against its plain version, exact int8 equality, in both modes,
    without noise, with supplied noise and with its Philox noise (the plain version
    reads ``philox_uniform``'s host bits); the scale bit-equal to the CPU's; at the
    tests' shapes, a scalar-path case and the int8 cache's 50,000 x 256. Then the
    Philox properties at 50,000 x 256. Returns the largest difference (0)."""
    from dgll_tpu_torch.ops import quantize as q
    from dgll_tpu_torch.ops.cuda.quantize import quantize_int8_cuda

    gen = torch.Generator(device="cuda").manual_seed(16)
    worst = 0
    cases = [(300, 64, True), (257, 100, True), (1, 1, True), (40, 7, True),
             (333, 64, False), (50_000, 256, True)]
    for n, d, aligned in cases:
        x = _quantize_inputs(n, d, gen, aligned)
        scale = q.column_scale(x)
        check(torch.equal(scale.cpu().view(torch.int32),
                          q.column_scale(x.cpu()).view(torch.int32)), "scale bit-equal")
        noise = torch.rand(n, d, generator=gen, device="cuda") - 0.5
        philox = torch.from_numpy(q.philox_uniform(n, d, 5)).cuda()
        for mode in q.MODES:
            for label, kw, u in (("none", {}, None), ("supplied", {"noise": noise}, noise),
                                 ("philox", {"seed": 5}, philox)):
                got = quantize_int8_cuda(x, scale, mode, **kw)
                want = q.quantize_int8_reference(x, scale, mode, u)
                diff = int((got.int() - want.int()).abs().max())
                worst = max(worst, diff)
                check(diff == 0, f"K8 equals its plain version ({n}x{d}, aligned "
                                 f"{aligned}, {mode}, noise {label})")
        print(f"[16 check] {n}x{d} aligned={aligned}: K8 equals its plain version "
              f"exactly in both modes, without noise, with supplied and Philox noise; "
              f"scale bit-equal to the CPU's")
    torch.cuda.synchronize()
    worst = max(worst, _fill_check(gen))
    # Philox: seeded, unbiased, within one step of round-to-nearest
    x = _quantize_inputs(50_000, 256, gen)
    det = q.quantize_int8(x)
    for make in (q.quantize_int8_stochastic,
                 lambda v, seed: q.quantize_int8(v, stochastic=True, seed=seed)):
        a, b, c = make(x, seed=11), make(x, seed=11), make(x, seed=12)
        check(torch.equal(a.values, b.values), "Philox repeats bitwise for one seed")
        check(not torch.equal(a.values, c.values), "Philox differs for another seed")
        step = int((a.values.int() - det.values.int()).abs().max())
        check(step <= 1, "Philox within 1 of round to nearest")
        bias = ((a.dequantize() - x).mean() / x.abs().mean()).abs().item()
        err = q.quantization_error(x, a)
        check(bias < 1e-3, f"relative mean bias {bias:.3e} below 1e-3")
        check(err < 0.02, f"quantization_error {err:.4f} below 0.02")
        print(f"[16 check] Philox at 50000x256 ({x.numel()} values): repeatable, "
              f"seed-dependent, max step {step} from round to nearest, relative mean "
              f"bias {bias:.3e}, quantization_error {err:.5f}")
    return float(worst)


# K8's fill cases (phase 16): (n, d, aligned, NaN column); n below one front of the
# column-max pass (3 rows at d=256, 1 row), d % 4 != 0 (100, 7, 1), x misaligned
FILL_CASES = ((300, 64, True, True), (257, 100, True, False), (1, 1, True, False),
              (40, 7, True, True), (333, 64, False, True), (3, 256, True, False),
              (1, 256, True, True), (5000, 2048, True, True), (50_000, 256, True, True),
              (50_000, 256, False, False))


def _fill_check(gen) -> int:
    """Phase 16: K8's whole fill (``quantize_int8_fill_cuda``, one C call) against the
    plain fill (``quantize_int8_fill_reference``: column maxima over row tiles, the
    scale, the plain pass) on the same inputs, q exactly and the scale bit for bit, in
    both modes, without noise, with supplied noise (aligned and a view 4 bytes into
    its buffer) and with Philox noise, on ``FILL_CASES``: a zero column (scale
    1e-12 / 127) and, where asked, a NaN in column 2 (scale NaN, its values 0); the
    plain fill's scale bit-equal to ``column_scale``'s on the card. Returns the largest
    difference (0)."""
    from dgll_tpu_torch.ops import quantize as q
    from dgll_tpu_torch.ops.cuda.quantize import quantize_int8_fill_cuda

    worst = 0
    for n, d, aligned, nan in FILL_CASES:
        x = _quantize_inputs(n, d, gen, aligned)
        if nan:
            x[n // 2, 2] = float("nan")
        nbuf = torch.empty(n * d + 1, device="cuda")
        noise = nbuf[(0 if aligned else 1):][:n * d].view(n, d)
        noise.copy_(torch.rand(n, d, generator=gen, device="cuda") - 0.5)
        philox = torch.from_numpy(q.philox_uniform(n, d, 7)).cuda()
        for mode in q.MODES:
            for label, kw, u in (("none", {}, None), ("supplied", {"noise": noise}, noise),
                                 ("philox", {"seed": 7}, philox)):
                got_q, got_s = quantize_int8_fill_cuda(x, mode, **kw)
                want_q, want_s = q.quantize_int8_fill_reference(x, mode, u)
                what = f"K8's fill equals the plain fill ({n}x{d}, aligned {aligned}, NaN " \
                       f"{nan}, {mode}, noise {label})"
                check(torch.equal(got_s.view(torch.int32), want_s.view(torch.int32)),
                      what + ": scale bits")
                diff = int((got_q.int() - want_q.int()).abs().max())
                worst = max(worst, diff)
                check(diff == 0, what + ": q")
        check(torch.equal(want_s.view(torch.int32), q.column_scale(x).view(torch.int32)),
              "the plain fill's scale is column_scale's")
        if nan:
            check(bool(torch.isnan(got_s[2])) and not bool(got_q[:, 2].any()),
                  "a NaN column: scale NaN, values 0")
        if d > 3:
            check(got_s[3].item() == np.float32(1e-12) / np.float32(127), "zero column")
    torch.cuda.synchronize()
    print(f"[16 check] K8's fill equals the plain fill, q exactly and scale bit for bit, "
          f"in both modes and all three noise sources, on {len(FILL_CASES)} shapes "
          f"(1-50,000 rows, d 1-2,048, d % 4 != 0, misaligned x and noise, zero and NaN "
          f"columns)")
    return worst


def phase_quantize_time() -> dict:
    """Phase 16: K8 at the int8 cache's fill shape (50,000 x 256, no noise, "xla"
    mode). The pass alone (``quantize_int8_cuda``, the scale given), beside its plain
    version, ``torch.fake_quantize_per_channel_affine`` over [-127, 127] (the same
    rounding to a float result; the port never calls it) and its bound: x read, q
    written and the scales, 4 float32 operations per value; also with supplied noise.
    Then the whole fill, what ``HBMFeatureCache.fill`` runs (``quantize_int8_fill_cuda``,
    one C call), beside the plain fill and the parent's composition (``column_scale``
    on the card, then the pass), in turns; there is no one library call of the whole
    fill. Its bound is the pass's: x read once, q and the scale written. Then the
    peak memory of one fill and of the composition above what is held."""
    from dgll_tpu_torch.ops import quantize as q
    from dgll_tpu_torch.ops.cuda.quantize import quantize_int8_cuda, quantize_int8_fill_cuda
    from dgll_tpu_torch.utils.profiling import cuda_median_ms

    gen = torch.Generator(device="cuda").manual_seed(17)
    x = _quantize_inputs(50_000, 256, gen)
    scale = q.column_scale(x)
    zero = torch.zeros(256, dtype=torch.int32, device="cuda")
    noise = torch.rand(x.shape, generator=gen, device="cuda") - 0.5
    result = {}
    for label, u in (("pass alone", None), ("pass alone, supplied noise", noise)):
        kw = {} if u is None else {"noise": u}
        reads = (x, scale) if u is None else (x, scale, u)
        case = Case(lambda: quantize_int8_cuda(x, scale, "xla", **kw),
                    lambda: q.quantize_int8_reference(x, scale, "xla", u),
                    lambda: torch.fake_quantize_per_channel_affine(x, scale, zero, 1,
                                                                   -127, 127),
                    reads, 4 * x.numel())
        t = timed(case, (quantize_int8_cuda(x, scale, "xla", **kw),))
        gbs = (nbytes(*reads) + x.numel()) / (t["ms"] * 1e-3) / 1e9
        print(f"[16 time] 50000x256 {label}: {describe(t)}; {gbs:.1f} GB/s moved")
        result[label] = t
    case = Case(lambda: quantize_int8_fill_cuda(x, "xla"),
                lambda: q.quantize_int8_fill_reference(x, "xla"), None, (x,), 4 * x.numel())
    t = timed(case, quantize_int8_fill_cuda(x, "xla"))
    calls = {"composition": lambda: quantize_int8_cuda(x, q.column_scale(x), "xla"),
             "fill": lambda: quantize_int8_fill_cuda(x, "xla")}
    turns = [cuda_median_ms(calls[k]) for k in ("composition", "fill", "fill", "composition")]
    t["composition_ms"] = (turns[0] + turns[3]) / 2
    print(f"[16 time] 50000x256 whole fill: {describe(t)}; in turns, column_scale + pass / "
          f"fill / fill / column_scale + pass: "
          + " / ".join(f"{v:.4f}" for v in turns) + " ms")
    peaks = {}
    for name, fn in (("fill", lambda: quantize_int8_fill_cuda(x, "xla")),
                     ("column_scale + pass", lambda: quantize_int8_cuda(x, q.column_scale(x),
                                                                        "xla"))):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - held) / 1e6
        del out
    t["peak_mb"], t["composition_peak_mb"] = peaks["fill"], peaks["column_scale + pass"]
    print(f"[16 time] 50000x256 peak memory above the held: fill {peaks['fill']:.3f} MB, "
          f"column_scale + pass {peaks['column_scale + pass']:.3f} MB (x itself: "
          f"{nbytes(x) / 1e6:.1f} MB)")
    check(peaks["column_scale + pass"] - peaks["fill"] >= 0.99 * nbytes(x) / 1e6,
          "the fill's peak is an [n, d] float32 temporary below the composition's")
    result["whole fill"] = t
    return result


def _all_counters() -> dict:
    from dgll_tpu_torch.ops.cuda import probes
    from dgll_tpu_torch.ops.cuda import quantize as k8
    from dgll_tpu_torch.ops.cuda import spmm_windowed as sw

    return {**_counters(), "K2 fwd": sw.launches_fwd, "K2 bwd": sw.launches_bwd,
            "K8": k8.launches, **probes.launches}


def _zero_all_counters() -> None:
    from dgll_tpu_torch.ops.cuda import probes
    from dgll_tpu_torch.ops.cuda import quantize as k8
    from dgll_tpu_torch.ops.cuda import spmm_windowed as sw

    _zero_counters()
    sw.launches_fwd = sw.launches_bwd = 0
    k8.launches = 0
    for k in probes.launches:
        probes.launches[k] = 0


def minibatch_split(args, batches: int = 10) -> dict:
    """One batch of the CLI's minibatch path taken apart, ``batches`` times, each part
    ending in a synchronise: sampling on the host, the blocks' copies to the card, the
    feature fetch (the cache's, or the gather from the card-resident features) and
    the train step; then a whole overlapped epoch (``run_epoch`` with the loader's
    producer thread and the fetch worker) traced for the device's idle share. Means in
    ms per batch."""
    from dgll_tpu_torch import run
    from dgll_tpu_torch.dataloader import DataLoader
    from dgll_tpu_torch.sampling import HostGraph
    from dgll_tpu_torch.tools.profile_slice import profile
    from dgll_tpu_torch.train import MiniBatchTrainer
    from dgll_tpu_torch.utils import PhaseTimer, get_logger, parse_train_config

    cfg = parse_train_config(args)
    dev = torch.device("cuda")
    g = run.build_dataset(cfg)
    n_class = int(g.labels[: g.n_real_node].max()) + 1
    model = run.build_model(cfg, n_class, g.node_feat.shape[1],
                            generator=torch.Generator().manual_seed(0))
    cfg, g, model, _, cache, fetch = run.prepare_pipeline(
        cfg, g, model, n_class, 0, PhaseTimer(), {}, dev, get_logger())
    tr = MiniBatchTrainer(model, run.make_optimizer(cfg), device=dev)
    state = tr.init_state()
    feats = None if fetch is not None else g.node_feat.to(dev)
    labels = g.labels.to(dev)
    sampler, hg, seeds, b = run.build_sampler(cfg), HostGraph.from_graph(g), \
        g.get_train_nodes(), cfg.batch_size
    timer = PhaseTimer()
    for i in range(batches + 1):
        if i == 1:
            timer = PhaseTimer()  # the first batch warms the allocator and cuBLAS
        with timer.phase("sample"):
            inp, _, blocks = sampler.sample(hg, seeds[i * b:(i + 1) * b], pad_to=b)
        with timer.phase("copy"):
            blocks = [blk.to(dev) for blk in blocks]
            torch.cuda.synchronize()
        with timer.phase("fetch"):
            x = fetch(inp) if fetch is not None else feats.index_select(0, blocks[0].src_ids)
            torch.cuda.synchronize()
        with timer.phase("step"):
            blocks, x, y, m = tr.batch_inputs(blocks, feats, labels, x)
            state, loss = tr.step(state, blocks, x, y, m, tr.generator)
            torch.cuda.synchronize()
    split = {k: 1e3 * timer.mean(k) for k in ("sample", "copy", "fetch", "step")}
    loader = DataLoader(g, seeds, sampler, b, seed=0, device=dev)
    prof = profile(lambda: tr.run_epoch(state, loader, feats, labels, fetch_fn=fetch))
    split.update(n_batches=len(loader), epoch_ms_per_batch=prof["wall_ms"] / len(loader),
                 busy_ms_per_batch=prof["busy_ms"] / len(loader),
                 idle_share=prof["idle_share"],
                 top_kernels={k: v["share"] for k, v in list(prof["kernels"].items())[:4]})
    return split


def phase_minibatch_cli() -> dict:
    """Phase 17: the CLI's host minibatch path at full width, ``MINIBATCH_EPOCHS``
    epochs each of GraphSAGE with the feature cache on 25% of the rows and of GCN
    without it (the JAX CLI's default model), with every launch counter set to 0
    just before each run and read just after (the path launches none of the port's
    kernels: its aggregations are plain PyTorch, as XLA in the JAX package); then
    each run's split (``minibatch_split``)."""
    from dgll_tpu_torch import run

    result = {}
    for name, extra in MINIBATCH_RUNS:
        args = [*MINIBATCH_ARGS, *extra]
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _zero_all_counters()
        with contextlib.redirect_stdout(io.StringIO()):  # the CLI's own JSON line
            out = run.main([*args, "--n_epochs", str(MINIBATCH_EPOCHS)])
        counts = {k: v for k, v in _all_counters().items() if v}
        peak = _peak_memory(held)
        trial = out["trials"][0]
        losses, secs = trial["epoch_loss"], trial["epoch_s"]
        check(trial["epochs"] == MINIBATCH_EPOCHS, f"{MINIBATCH_EPOCHS} epochs ran")
        check(all(np.isfinite(losses)), "every loss is finite")
        check(trial["test_acc"] > 2 / 16, f"{name}: test_acc above 2/16")
        check(not counts, f"{name}: no kernel launch on the path, got {counts}")
        cache = ""
        if "--cached_nPercent" in extra:
            check(trial["cached_rows"] == 50_000, "the cache holds 25% of the rows")
            cache = (f", cache_miss_rate {trial['cache_miss_rate']:.4f}, cached_rows "
                     f"{trial['cached_rows']}, cache_lookups {trial['cache_lookups']}")
        split = minibatch_split(args)
        n_batches = split["n_batches"]
        print(f"[17 cli] {name}: loss {' -> '.join(f'{v:.4f}' for v in losses)}, test_acc "
              f"{trial['test_acc']:.4f}, epoch s {[round(v, 3) for v in secs]} "
              f"({n_batches} train batches an epoch: "
              f"{1e3 * np.mean(secs[1:]) / n_batches:.2f} ms per batch after the first "
              f"epoch), train_s {trial['train_s']:.3f}, total_s {trial['total_s']:.3f}"
              f"{cache}, {peak}")
        print(f"[17 split] {name}: per batch, each part alone: sample "
              f"{split['sample']:.3f} ms, copies {split['copy']:.3f} ms, fetch "
              f"{split['fetch']:.3f} ms, step {split['step']:.3f} ms; overlapped epoch "
              f"{split['epoch_ms_per_batch']:.3f} ms per batch, device busy "
              f"{split['busy_ms_per_batch']:.3f} ms per batch, idle "
              f"{100 * split['idle_share']:.2f}%; top kernels "
              + ", ".join(f"{100 * v:.1f}% {k}" for k, v in split["top_kernels"].items()))
        result[name] = {"trial": {k: trial[k] for k in (
            "test_acc", "epoch_loss", "epoch_s", "train_s", "total_s",
            *(("cache_miss_rate", "cached_rows", "cache_lookups") if cache else ()))},
            "split": split}
    return result


def _cache_scenario(seed: int = 0):
    """``benchmarks/cache_bench.py``'s scenario: 200,000 nodes, 256 features on the
    host, 32 random classes, average degree 12 on its power-law access graph (hub
    nodes dominate as neighbours), fanouts [10, 5], batch 1024, a pool of 12 batches.
    Returns (host features, labels on the card, host graph, out-degrees, pool)."""
    from dgll_tpu_torch.sampling import HostGraph, NeighborSampler

    n, d, deg, batch, n_class = 200_000, 256, 12, 1024, 32
    rng = np.random.default_rng(seed)
    host_feats = rng.standard_normal((n, d), dtype=np.float32)
    labels = torch.from_numpy(rng.integers(0, n_class, n).astype(np.int32)).cuda()
    w = (np.arange(n, dtype=np.float64) + 1.0) ** -1.0
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    src = np.searchsorted(cdf, rng.random(n * deg)).astype(np.int64)
    dst = np.sort(rng.integers(0, n, n * deg))
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, dst + 1, 1)
    hg = HostGraph(np.cumsum(indptr), src, n)
    sampler = NeighborSampler([10, 5], seed=0)
    pool = []
    for _ in range(12):
        inp, _, blocks = sampler.sample(hg, rng.integers(0, n, batch), pad_to=batch)
        pool.append((inp, [b.to("cuda") for b in blocks]))
    return host_feats, labels, np.bincount(src, minlength=n), pool


def phase_cache() -> dict:
    """Phase 18: the feature cache's scenario through ``MiniBatchTrainer``'s step
    (GraphSAGE, hidden 256, 32 classes, dropout 0, Adam 1e-3), each run from the same
    parameters over the same 12 batches: the device-resident features (a gather on
    the card), float32 caches on 0, 25 and 100% of the top out-degree rows, and
    float32 against int8 at a budget of 6.25% of the rows in float32. Each run's
    first pass gives its losses, ms per batch is the best of 3 passes (one warm-up
    step first). The 100% cache's losses equal the device-resident run's within
    1e-5; the int8 run counts exactly one K8 launch (its one fill, of 50,000 x 256).
    Each budget run records the peak memory of its fill above what was held (the
    rows staged in float32 on the card, then the cache)."""
    import copy
    import functools as ft

    from dgll_tpu_torch.cache import HBMFeatureCache
    from dgll_tpu_torch.nn import GraphSAGE
    from dgll_tpu_torch.ops.cuda import quantize as k8
    from dgll_tpu_torch.ops.quantize import quantization_error, quantize_int8
    from dgll_tpu_torch.train import MiniBatchTrainer

    host_feats, labels, out_degree, pool = _cache_scenario()
    n, d = host_feats.shape
    model0 = GraphSAGE(d, 256, 32, dropout=0.0, generator=torch.Generator().manual_seed(0))

    def run(fetch):
        tr = MiniBatchTrainer(copy.deepcopy(model0), ft.partial(torch.optim.Adam, lr=1e-3))
        state = tr.init_state()

        def one(inp, blocks):
            nonlocal state
            blocks, x, y, m = tr.batch_inputs(blocks, None, labels, fetch(inp))
            state, loss = tr.step(state, blocks, x, y, m, tr.generator)
            return loss

        losses = [one(*b) for b in pool]
        first = [float(v) for v in losses]
        one(*pool[0])  # warm-up
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in pool:
                loss = one(*b)
            float(loss)
            best = min(best, time.perf_counter() - t0)
        return first, best / len(pool) * 1e3

    rows = {}
    feats_dev = torch.from_numpy(host_feats).cuda()
    rows["device_resident"] = dict(zip(("losses", "ms_per_batch"), run(
        lambda ids: feats_dev.index_select(0, torch.from_numpy(ids).cuda()))))
    del feats_dev
    for frac in (0.0, 0.25, 1.0):
        cache = HBMFeatureCache(host_feats)
        if frac > 0:
            k = int(frac * n)
            cache.fill(np.argpartition(-out_degree, k - 1)[:k])
        cache.reset_counters()
        losses, ms = run(cache.fetch)
        rows[f"f32_{int(frac * 100)}pct"] = {"losses": losses, "ms_per_batch": ms,
                                             "miss_rate": cache.miss_rate()[0],
                                             "cached_rows": cache.k}
        del cache
    budget = int(0.0625 * n) * d * 4
    for quantize in (False, True):
        _zero_all_counters()
        cache = HBMFeatureCache(host_feats, quantize=quantize)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        k = cache.auto_cache(out_degree, budget)
        torch.cuda.synchronize()
        fill_peak_mb = (torch.cuda.max_memory_allocated() - held) / 1e6
        launches = k8.launches
        losses, ms = run(cache.fetch)
        check(k8.launches == launches, "fetch launches no K8")
        row = {"losses": losses, "ms_per_batch": ms, "miss_rate": cache.miss_rate()[0],
               "cached_rows": k, "byte_budget_mb": budget / 1e6, "k8_launches": launches,
               "fill_peak_mb": fill_peak_mb}
        if quantize:
            check(launches == 1, f"one K8 launch for the int8 fill, got {launches}")
            check(k == 4 * int(0.0625 * n), "int8 holds four times the rows")
            row["dequant_rel_err"] = quantization_error(
                host_feats[:4096], quantize_int8(torch.from_numpy(host_feats[:4096]).cuda()))
        rows[f"budget_6.25pct_{'int8' if quantize else 'f32'}"] = row
        del cache
    ref = rows["device_resident"]["losses"]
    full = rows["f32_100pct"]["losses"]
    diff = max(abs(a - b) for a, b in zip(full, ref))
    check(diff <= 1e-5, f"the 100% cache's losses equal the device-resident run's "
                        f"(max diff {diff:.3e})")
    check(all(np.isfinite(r["losses"]).all() for r in rows.values()), "finite losses")
    for name, r in rows.items():
        extra = ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                          for k, v in r.items() if k not in ("losses", "ms_per_batch"))
        print(f"[18 cache] {name}: {r['ms_per_batch']:.3f} ms per batch, loss "
              f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f}" + (f", {extra}" if extra else ""))
    print(f"[18 cache] the 100% cache's losses against the device-resident run's: max "
          f"diff {diff:.3e}")
    return {name: {k: v for k, v in r.items() if k != "losses"} for name, r in rows.items()}


# P2b's ragged cases (phase 19): row counts against its 64-row M tiles, windows that
# need zero rows up to a K step of 16, widths cut into column slices (96: 32 a pass;
# 192: 64); values of either sign from 1e-30 to 1e30, inside the range over which the
# split into three bfloat16 parts is exact (2^-103 .. FLT_MAX)
P2B_RAGGED = {"e": (1, 63, 65), "win": (8, 264), "f": (96, 192)}


def _p2b_build_lines() -> str:
    """P2b's kernel instances as ptxas reported them in the build's log: registers,
    spilled bytes, and any note that it serialised their ``wgmma``."""
    from dgll_tpu_torch.ops.cuda import build

    log = build.library_path().with_suffix(".log")
    entry, regs, spills, notes = None, {}, {}, []
    for line in (log.read_text() if log.exists() else "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"onehot_kernelILi(\d+)E", entry or "")
        if "wgmma" in line and "onehot_kernel" in line:
            notes.append(line.strip())
        if not m:
            continue
        if (r := re.search(r"Used (\d+) registers", line)):
            regs[int(m.group(1))] = int(r.group(1))
        if (r := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            spills[int(m.group(1))] = (int(r.group(1)), int(r.group(2)))
    check(sorted(regs) == [16, 32, 64, 128], f"P2b's four instances in the build log: {regs}")
    return ("; ".join(f"onehot_kernel<{n}> {regs[n]} registers, spills {spills.get(n)}"
                      for n in sorted(regs))
            + (f"; {len(notes)} notes: {notes}" if notes else "; no wgmma serialised"))


def _probe_p2b_ragged(gen: torch.Generator) -> int:
    """Phase 19: P2b on every combination of ``P2B_RAGGED``, with an index past the
    window's padding and one negative, bitwise against its plain version and within
    ``probe.max_error``'s bar. Returns the number of cases."""
    from dgll_tpu_torch.ops import probes as pp
    from dgll_tpu_torch.ops.cuda import probes as kp
    from dgll_tpu_torch.tools import probe

    n = 0
    for e in P2B_RAGGED["e"]:
        for win_rows in P2B_RAGGED["win"]:
            for f in P2B_RAGGED["f"]:
                mag = 10.0 ** (torch.rand(win_rows, f, generator=gen, device="cuda") * 60 - 30)
                sign = torch.randint(0, 2, (win_rows, f), generator=gen, device="cuda") * 2 - 1
                win = (mag * sign).float()
                idxv = torch.randint(0, win_rows + 12, (e, 1), dtype=torch.int32,
                                     generator=gen, device="cuda")
                idxv[0] = win_rows + 100
                if e > 1:
                    idxv[-1] = -3
                got, want = kp.p2b_onehot_cuda(idxv, win), pp.p2b_onehot_reference(idxv, win)
                probe.max_error("p2b_onehot", got, want)
                check(torch.equal(got, want), f"P2b bitwise at E={e}, WIN={win_rows}, F={f}")
                n += 1
    return n


def _probe_edge_cases() -> None:
    """Phase 19: the probe kernels on ragged shapes against their plain versions, at
    the probes' bars: row counts that no tile, chunk or unroll divides, narrow and odd
    widths, and for P2b an index outside the window (a zero row); then P2b's ragged
    tiles (``_probe_p2b_ragged``) bitwise, and its build."""
    from dgll_tpu_torch.ops import probes as pp
    from dgll_tpu_torch.ops.cuda import probes as kp
    from dgll_tpu_torch.tools import probe

    gen = torch.Generator(device="cuda").manual_seed(191)

    def ids(shape, hi):
        return torch.randint(0, hi, shape, dtype=torch.int32, generator=gen, device="cuda")

    def rows(n, f):
        return torch.randn(n, f, generator=gen, device="cuda")

    win32, win128 = rows(256, 32), rows(256, 128)
    idxv = ids((1000, 1), 256)
    idxv[7] = 256
    cases = [("p0_copy", (rows(1001, 4),)),
             ("p2_dynread", (ids((2, 500), 256), win128)),
             ("p2b_onehot", (idxv, win32)),
             ("p2b_onehot", (idxv[:40], win128)),
             ("p3_dynacc", (ids((2, 500), 100), rows(1000, 36), 100)),
             ("p4_dma", (ids((2, 500), 3000), rows(3000, 128))),
             ("p4_dma", (ids((3, 7), 50), rows(50, 4)))]
    for key, args in cases:
        probe.max_error(key, kp.KERNELS[key](*args), getattr(pp, f"{key}_reference")(*args))
    # P4 in both of its paths (the plan takes the direct one at these sizes): buckets of
    # 16 rows, ids spread, in one bucket only and in the last, partial bucket
    p4_cases = [args for key, args in cases if key == "p4_dma"]
    p4_cases += [(ids((4, 300), 16) + 32, rows(3000, 128)), (ids((4, 300), 8) + 2992, rows(3000, 64))]
    for idx, x in p4_cases:
        want = pp.p4_dma_reference(idx, x)
        for plan in (pp.P4Plan(bucketed=False), pp.p4_bucketed_plan(x.shape[0], x.shape[1],
                                                                    16 * 4 * x.shape[1])):
            probe.max_error("p4_dma", kp.p4_dma_cuda(idx, x, plan), want)
    n_p2b = _probe_p2b_ragged(gen)
    torch.cuda.synchronize()
    print(f"[19 probes] {len(cases)} ragged cases (rows 21-1001, widths 4-128, an index "
          f"outside P2b's window) agree with the plain versions; P4 also in both paths on "
          f"{len(p4_cases)} cases (ids in one bucket, in the last partial bucket); P2b "
          f"bitwise on {n_p2b} more (E {P2B_RAGGED['e']}, WIN {P2B_RAGGED['win']}, F "
          f"{P2B_RAGGED['f']}, values 1e-30..1e30, ids outside the window)")
    print(f"[19 probes] P2b's build: {_p2b_build_lines()}")


# P4's further shapes (phase 19) are GAT's msg = h[src] gather (the slices' graph's
# own dst-major ids, gat_fused.py:290) and item 1's feature gather, (rows, F, E) below:
# a [15, 10] sample of a 1024 batch; uniform ids stand in for the device sampler's,
# which the port does not have yet
P4_ITEM1 = (2_400_000, 100, 1024 * (1 + 15 + 150))


def _probe_p4_shapes(x: torch.Tensor, idx: torch.Tensor) -> dict:
    """Phase 19: P4 at the probe's size, at GAT's gather and at item 1's feature
    gather, in both paths, each exactly against its plain version; then the two paths
    and ``index_select`` timed in turns (direct, bucketed, index_select, index_select,
    bucketed, direct; each a median of 15), beside the plan's choice and the bound
    (the ids, the table rows they touch and the output, once each)."""
    from dgll_tpu_torch.ops import probes as pp
    from dgll_tpu_torch.ops.cuda import probes as kp
    from dgll_tpu_torch.utils.profiling import cuda_median_ms

    gen = torch.Generator(device="cuda").manual_seed(193)
    c, _, n_node = slice_graph()
    rows, f, e = P4_ITEM1
    shapes = {
        "probe": (x, idx.view(-1)),
        "GAT msg = h[src]": (torch.randn(n_node, 64, generator=gen, device="cuda"), c.src),
        "item 1 features": (torch.randn(rows, f, generator=gen, device="cuda"),
                            torch.randint(0, rows, (e,), dtype=torch.int32, generator=gen,
                                          device="cuda")),
    }
    result = {}
    for label, (tab, ids) in shapes.items():
        (rows, f), e = tab.shape, ids.numel()
        want = pp.p4_dma_reference(ids, tab)
        paths = {"direct": pp.P4Plan(bucketed=False), "bucketed": pp.p4_bucketed_plan(rows, f)}
        for path, plan in paths.items():
            check(torch.equal(kp.p4_dma_cuda(ids, tab, plan), want),
                  f"P4 {path} equals its plain version exactly at {label}")
        del want
        calls = {"direct": lambda: kp.p4_dma_cuda(ids, tab, paths["direct"]),
                 "bucketed": lambda: kp.p4_dma_cuda(ids, tab, paths["bucketed"]),
                 "index_select": lambda: tab.index_select(0, ids)}
        ms = collections.defaultdict(list)
        for k in ("direct", "bucketed", "index_select", "index_select", "bucketed", "direct"):
            ms[k].append(cuda_median_ms(calls[k]))
        t = {k: sum(v) / 2 for k, v in ms.items()}
        touched = int(torch.unique(ids).numel())
        t["bound_ms"] = bound(nbytes(ids) + (touched + e) * f * 4, 0)[0]
        t["plan"] = "bucketed" if pp.p4_plan(rows, f, e).bucketed else "direct"
        result[label] = t
        print(f"[19 probes] p4_dma at {label} ([{rows}, {f}], {e} ids, {e / rows:.2f} a "
              f"row, {touched} rows touched): exact in both paths; direct "
              f"{t['direct']:.4f} ms, bucketed {t['bucketed']:.4f}, index_select "
              f"{t['index_select']:.4f}, bound {t['bound_ms']:.4f}; the plan takes "
              f"{t['plan']} ({t['bound_ms'] / t[t['plan']]:.1%} of the bound, "
              f"{t['index_select'] / t[t['plan']]:.2f}x index_select)")
    return result


def _probe_p3_contended(msg: torch.Tensor) -> None:
    """Phase 19: P3 under contention. All of ``msg``'s rows, rounded to integers (so
    that every order of the f32 sums is exact), go into few destination rows: one
    atomic row an edge onto a few hub rows. Exact against its plain version, then
    timed beside ``index_add_``."""
    from dgll_tpu_torch.ops.cuda import probes as kp
    from dgll_tpu_torch.ops.probes import p3_dynacc_reference
    from dgll_tpu_torch.utils.profiling import cuda_median_ms

    gen = torch.Generator(device="cuda").manual_seed(192)
    ints = torch.round(msg)
    e, f = ints.shape
    for rows in P3_HUB_ROWS:
        idx = torch.randint(0, rows, (e // 512, 512), dtype=torch.int32, generator=gen,
                            device="cuda")
        check(torch.equal(kp.p3_dynacc_cuda(idx, ints, rows),
                          p3_dynacc_reference(idx, ints, rows)), f"P3 into {rows} rows exact")
        t = cuda_median_ms(lambda: kp.p3_dynacc_cuda(idx, ints, rows))
        lib = cuda_median_ms(lambda: torch.zeros(rows, f, device="cuda").index_add_(
            0, idx.view(-1), ints))
        print(f"[19 probes] p3_dynacc into {rows} rows ({e // rows} message rows a "
              f"destination): exact; {t:.4f} ms, {t * 1e6 / e:.4f} ns a row; index_add_ "
              f"{lib:.4f} ms")


def _probe_p0_turns(msg: torch.Tensor, rounds: int = 3) -> None:
    """Phase 19: P0 against ``copy_`` into a kept buffer and ``clone`` (a fresh
    one), timed in alternating turns (P0, copy_, clone, clone, copy_, P0, ``rounds``
    times; each a median of 15 CUDA-event timings), so that a drift of the card
    between timings falls on all three alike."""
    from dgll_tpu_torch.ops.cuda import probes as kp
    from dgll_tpu_torch.utils.profiling import cuda_median_ms

    out = torch.empty_like(msg)
    calls = {"P0": lambda: kp.p0_copy_cuda(msg), "copy_": lambda: out.copy_(msg),
             "clone": lambda: msg.clone()}
    ms = collections.defaultdict(list)
    for _ in range(rounds):
        for name in ("P0", "copy_", "clone", "clone", "copy_", "P0"):
            ms[name].append(cuda_median_ms(calls[name]))
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    print(f"[19 probes] p0_copy in turns with copy_ and clone, ms (mean of "
          f"{2 * rounds}): P0 {mean['P0']:.4f}, copy_ {mean['copy_']:.4f} "
          f"({mean['P0'] / mean['copy_']:.3f}x), clone {mean['clone']:.4f} "
          f"({mean['P0'] / mean['clone']:.3f}x); each turn: "
          + "; ".join(f"{k} " + " ".join(f"{t:.4f}" for t in v) for k, v in ms.items()))


def phase_probe_kernels() -> dict:
    """Phase 19: each probe's kernel (``csrc/probes.cu``, uncounted launches) against
    its plain version at the script's full sizes (``tools/probe.make_data`` and
    ``probe_calls``): P0, P2 and P4 exactly, P2b elementwise within rtol 1e-5, P3
    within rtol 1e-4 and 1e-5 x max|ref| (``tools/probe.max_error``); then each timed
    beside its plain version, one library call (``copy_``, ``index_select``,
    ``index_add_``) and its bound; P4 at two further shapes (``_probe_p4_shapes``);
    P0 against ``copy_`` and ``clone`` in turns; then P3 under contention. A gather's
    bytes count the
    table rows its ids touch. P2b is also held bitwise to its plain version (its split
    is exact at these values). Its bound is the larger of its bytes and the function's
    one product (2 x E x WIN x F operations) at TF32's 495 TFLOP/s: splitting win
    into three bf16 parts is the kernel's way to f32 accuracy, not work the function
    needs."""
    from dgll_tpu_torch.ops.cuda import probes as kp
    from dgll_tpu_torch.tools import probe
    from dgll_tpu_torch.utils.profiling import cuda_median_ms

    d = probe.make_data(torch.device("cuda"), seed=19)
    probe.check_ids(d)
    idx_c, idx_o, idx_h, msg, win, x = (d[k] for k in ("idx_chunk", "idx_out", "idx_hbm",
                                                       "msg", "win", "x32"))
    e, f = msg.shape
    row = f * 4

    def touched(idx):
        return int(torch.unique(idx).numel()) * row

    copy_out = torch.empty_like(msg)
    win_gather = nbytes(idx_c) + touched(idx_c) + e * row
    cases = {  # library call, bytes moved, operations, their rate
        "p0_copy": (lambda: copy_out.copy_(msg), 2 * nbytes(msg), 0, F32_OPS_PER_S),
        "p2_dynread": (lambda: win.index_select(0, idx_c.view(-1)), win_gather, 0,
                       F32_OPS_PER_S),
        "p2b_onehot": (lambda: win.index_select(0, idx_c.view(-1)), win_gather,
                       2 * e * win.shape[0] * f, TF32_OPS_PER_S),
        "p3_dynacc": (lambda: torch.zeros(probe.OUT_TILE, f, device="cuda").index_add_(
                          0, idx_o.view(-1), msg),
                      nbytes(idx_o, msg) + probe.OUT_TILE * row, e * f, F32_OPS_PER_S),
        "p4_dma": (lambda: x.index_select(0, idx_h.view(-1)),
                   nbytes(idx_h) + touched(idx_h) + e * row, 0, F32_OPS_PER_S),
    }
    _probe_edge_cases()
    calls = probe.probe_calls(d)
    result = {}
    for _, key, _ in PROBE_KERNELS:
        library, moved, ops, rate = cases[key]
        _, plain, args = calls[key]

        def kernel():
            return kp.KERNELS[key](*args)

        got, want = kernel(), plain(*args)
        err = probe.max_error(key, got, want)
        if key == "p2b_onehot":
            check(torch.equal(got, want), "P2b bitwise at the probe's size")
        del got, want
        torch.cuda.synchronize()
        t = {"ms": cuda_median_ms(kernel), "plain_ms": cuda_median_ms(lambda: plain(*args)),
             "library_ms": cuda_median_ms(library)}
        t["bound_ms"], t["bound_by"] = bound(moved, ops, rate)
        result[key] = {"err": err, "times": t}
        print(f"[19 probes] {key}: max abs err {err:.3e} against its plain version; "
              f"{describe(t)}; {moved / (t['ms'] * 1e-3) / 1e9:.1f} GB/s moved")
    result["p4_shapes"] = _probe_p4_shapes(x, idx_h)
    _probe_p0_turns(msg)
    _probe_p3_contended(msg)
    return result


def phase_probe_tool() -> tuple:
    """Phase 19: the probe tool's path (``python -m dgll_tpu_torch.tools.probe``) at
    the script's sizes, with every launch counter set to 0 just before it and read
    just after; each probe must have launched its kernel and no other kernel may
    have run. Returns (its JSON, the counters)."""
    from dgll_tpu_torch.ops.cuda import probes as kp
    from dgll_tpu_torch.tools import probe

    _zero_all_counters()
    with contextlib.redirect_stdout(io.StringIO()):  # the tool's own lines
        res = probe.main(["--device", "cuda", "--seed", "0"])
    counts = {k: v for k, v in _all_counters().items() if v}
    check(all(counts.get(k, 0) >= 1 for k in kp.launches), f"every probe launched: {counts}")
    check(set(counts) <= set(kp.launches), f"no other kernel launched: {counts}")
    rows = [k for k in res if isinstance(res[k], dict)]
    check(len(rows) == 8 and all(v > 0 and np.isfinite(v) for k in rows
                                 for v in res[k].values()), "finite positive probe rates")
    check(res["device"] == torch.cuda.get_device_name(0) and res["E"] == probe.E,
          "the tool ran on the card at the script's sizes")
    tbs = res["p0_stream_copy"]["gbps"] / 1e3
    print(f"[19 probes] tool: launches {counts}; P0 streams {tbs:.4f} TB/s, "
          f"{tbs / (HBM_BYTES_PER_S / 1e12):.1%} of the data sheet's 3.35 TB/s")
    return res, counts


# the flagship path (phase 20): the CLI's device-sampling runs on the slices' graph
# (MINIBATCH_ARGS), 3 epochs each; GAT at the published 8 heads x 8 (PERF.md §4)
FLAGSHIP_CLI_RUNS = (
    ("GraphSAGE, --device_sampling --exact_eval",
     ["--Model", "GraphSAGE", "--device_sampling", "--exact_eval"]),
    ("GCN, --device_sampling --exact_eval",
     ["--Model", "GCN", "--device_sampling", "--exact_eval"]),
    ("GAT, --device_sampling", ["--Model", "GAT", "--device_sampling", "--nhid", "8",
                                "--n_heads", "8", "--dropout", "0.6", "--lr", "0.005",
                                "--weight_decay", "0.0005"]))
# graph replays against eager steps of one batch function on the same inputs: the same
# kernels, but cuBLAS may pick another algorithm inside a capture, so within this of
# max|ref| rather than bitwise (on an H100 they have read bitwise equal)
GRAPH_TOL = 1e-6
FLAGSHIP_BATCHES = 8  # the graph-against-eager comparison's batches
GIN_TOL = 1e-5  # phase 22: the GIN classifier's forward on the card, x max|ref|


def _same_blocks(got, want, what: str) -> None:
    check(len(got) == len(want), f"{what}: as many blocks")
    for t, w in zip(got, want):
        check((t.fanout, t.n_dst) == (w.fanout, w.n_dst), f"{what}: block shapes")
        for name in ("dst_ids", "src_ids", "neigh_mask", "dst_mask"):
            check(torch.equal(getattr(t, name).cpu(), getattr(w, name)),
                  f"{what}: {name} equal on the card and the CPU")


def _flagship_sampler(data) -> None:
    """The device sampler on the card against the same function on the CPU, on the
    bench's graph at its shapes, with the same uniforms (drawn on the CPU): a batch
    of 1,024 train seeds in both modes; seeds of degree 0 and masked seeds; a graph
    with no edges."""
    from dgll_tpu_torch import bench
    from dgll_tpu_torch.sampling import DeviceCSR, sample_blocks_device
    from dgll_tpu_torch.sampling.device_sampler import draw_uniforms, layer_sizes

    cpu = DeviceCSR.from_host_arrays(data.indptr, data.src, "cpu")
    deg = np.diff(data.indptr)
    zero = np.flatnonzero(deg == 0)[:64]
    b = 1024
    cases = {"train seeds": (data.train_nodes[:b], np.ones(b, bool)),
             "degree 0 and masked": (np.concatenate([zero, data.train_nodes[:b - len(zero)]]),
                                     np.arange(b) % 5 != 3)}
    gen = torch.Generator().manual_seed(20)
    for window in (True, False):
        for name, (seeds, mask) in cases.items():
            draws = [draw_uniforms(n, f, window, gen) for n, f in
                     zip(layer_sizes(b, bench.FANOUTS), reversed(bench.FANOUTS))]
            seeds_t, mask_t = torch.from_numpy(seeds.astype(np.int32)), torch.from_numpy(mask)
            _, _, want = sample_blocks_device(cpu, seeds_t, mask_t, bench.FANOUTS,
                                              draws=draws, window=window)
            on_card = [tuple(t.cuda() for t in d) if window else d.cuda() for d in draws]
            _, _, got = sample_blocks_device(data.csr, seeds_t.cuda(), mask_t.cuda(),
                                             bench.FANOUTS, draws=on_card, window=window)
            _same_blocks(got, want, f"sampler, {name}, window={window}")
            if name != "train seeds":
                check(not got[-1].neigh_mask[: len(zero)].any().item(),
                      "degree-0 seeds draw no neighbour")
        empty_cpu = DeviceCSR.from_host_arrays(np.zeros(11, np.int64), np.zeros(0), "cpu")
        empty = DeviceCSR.from_host_arrays(np.zeros(11, np.int64), np.zeros(0), "cuda")
        seeds = torch.arange(10, dtype=torch.int32)
        draws = [draw_uniforms(n, f, window, gen) for n, f in
                 zip(layer_sizes(10, [4, 3]), (3, 4))]
        _, _, want = sample_blocks_device(empty_cpu, seeds, seeds % 2 == 0, [4, 3],
                                          draws=draws, window=window)
        _, _, got = sample_blocks_device(
            empty, seeds.cuda(), (seeds % 2 == 0).cuda(), [4, 3], window=window,
            draws=[tuple(t.cuda() for t in d) if window else d.cuda() for d in draws])
        _same_blocks(got, want, f"sampler, no edges, window={window}")
        check(not got[0].neigh_mask.any().item(), "a graph with no edges draws no neighbour")
    print(f"[20 sampler] card == CPU on the bench's graph ({data.n_node} nodes, "
          f"{len(data.src)} edges), both modes: 1,024 train seeds (blocks of "
          f"{layer_sizes(b, bench.FANOUTS)[-1] * (1 + bench.FANOUTS[0])} source ids); "
          f"{len(zero)} degree-0 seeds and every fifth masked; a graph with no edges")


def _flagship_graph_vs_eager(data) -> dict:
    """``FLAGSHIP_BATCHES`` batches as graph replays and as eager steps, each runner
    from the same weights, generator seed and draws; dropout 0, then 0.5 (masks from
    the runner's generator, registered with the graph)."""
    from dgll_tpu_torch import bench
    from dgll_tpu_torch.train import draw_epoch

    nodes = data.train_nodes[: FLAGSHIP_BATCHES * 1024]
    out = {}
    for dropout in (0.0, 0.5):
        draws = draw_epoch(FLAGSHIP_BATCHES, 1024, bench.FANOUTS, True,
                           torch.Generator("cuda").manual_seed(21), "cuda")
        runs = []
        for graph in (True, False):
            runner, state = bench.flagship_runner(data, 1024, True, cuda_graph=graph,
                                                  dropout=dropout, train_nodes=nodes)
            runner.run_epoch(state, data.feats, data.labels, draws=draws)
            runs.append((runner.batch_losses.clone(),
                         [p.detach().clone() for p in state.model.parameters()]))
        (lg, pg), (le, pe) = runs
        err_l = (lg - le).abs().max().item()
        err_p = max((a - b).abs().max().item() for a, b in zip(pg, pe))
        scale_p = max(b.abs().max().item() for b in pe)
        check(torch.isfinite(lg).all().item(), "finite losses")
        check(err_l <= GRAPH_TOL * le.abs().max().item(),
              f"dropout {dropout}: graph losses within {GRAPH_TOL} x max|ref| of eager")
        check(err_p <= GRAPH_TOL * scale_p,
              f"dropout {dropout}: graph parameters within {GRAPH_TOL} x max|ref| of eager")
        out[f"dropout {dropout}"] = {"max_abs_err_loss": err_l, "max_abs_err_param": err_p}
        print(f"[20 graph] dropout {dropout}: {FLAGSHIP_BATCHES} replays against eager "
              f"steps: losses {' '.join(f'{v:.6f}' for v in lg.tolist())}; max abs error "
              f"loss {err_l:.3e}, parameters {err_p:.3e}")
    return out


def _flagship_turns(data) -> dict:
    """The flagship epoch, ms a batch (the bench's timing: one warm-up epoch, then
    epochs ending in a read of the loss), in turns A B B A: graph against eager,
    block-window against per-slot, fused Adam against foreach (both capturable)."""
    from dgll_tpu_torch import bench

    fused, foreach = dict(capturable=True, fused=True), dict(capturable=True, foreach=True)
    configs = {"graph, window, fused": (True, True, fused),
               "eager, window, fused": (False, True, fused),
               "graph, per-slot, fused": (True, False, fused),
               "graph, window, foreach": (True, True, foreach)}
    runners = {}
    for name, (graph, window, adam) in configs.items():
        runner, state = bench.flagship_runner(data, 1024, window, adam, graph)
        float(runner.run_epoch(state, data.feats, data.labels)[1])  # warm-up, capture
        runners[name] = (runner, state)

    def epoch_ms(name):
        runner, state = runners[name]
        t0 = time.perf_counter()
        float(runner.run_epoch(state, data.feats, data.labels)[1])
        return (time.perf_counter() - t0) * 1e3 / runner.n_batches

    base = "graph, window, fused"
    # no host synchronisation inside a replayed epoch: any would raise here
    runner, state = runners[base]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, loss = runner.run_epoch(state, data.feats, data.labels)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(bool(torch.isfinite(loss)), "a finite epoch loss")
    print(f"[20 sync] one replayed epoch of {runner.n_batches} batches ran under "
          "torch.cuda.set_sync_debug_mode('error'): no host synchronisation inside it")
    out = {}
    for other in ("eager, window, fused", "graph, per-slot, fused",
                  "graph, window, foreach"):
        ms = {base: [], other: []}
        for name in (base, other, other, base):
            ms[name].append(epoch_ms(name))
        out[f"{base} | {other}"] = ms
        print(f"[20 turns] ms a batch, in turns {base} / {other} / {other} / {base}: "
              f"{ms[base][0]:.4f} / {ms[other][0]:.4f} / {ms[other][1]:.4f} / "
              f"{ms[base][1]:.4f} (vs_baseline {bench.BASELINE_MS / np.mean(ms[base]):.3f}"
              f" / {bench.BASELINE_MS / np.mean(ms[other]):.3f})")
    out["profile"] = _flagship_profile(*runners[base], data)
    return out


def _flagship_profile(runner, state, data) -> dict:
    """``profile_slice --device_sampling``'s numbers for the graph runner."""
    from dgll_tpu_torch.tools import profile_slice

    res = profile_slice.device_sampling_profile(runner, state, data.feats, data.labels)
    per = res["ms_per_batch"]
    print(f"[20 profile] one replayed epoch: wall {per['wall']:.4f} ms a batch, device "
          f"busy {per['busy']:.4f}, idle {100 * res['profile']['idle_share']:.2f}%; "
          "phases (ms a batch): " + ", ".join(f"{k} {v:.4f}" for k, v in
                                             res["phases_ms_per_batch"].items())
          + "; top kernels " + ", ".join(
              f"{100 * v['share']:.1f}% {k[:60]}" for k, v in
              list(res["profile"]["kernels"].items())[:5]))
    return res


def _flagship_cli() -> dict:
    """The CLI's device-sampling runs (``FLAGSHIP_CLI_RUNS``), every counter set to 0
    just before each and read just after: exact inference launches K1 (GCN's and
    GraphSAGE's mean, one call a layer), and nothing else launches a kernel of the
    port."""
    from dgll_tpu_torch import run

    out = {}
    for name, extra in FLAGSHIP_CLI_RUNS:
        _zero_all_counters()
        with contextlib.redirect_stdout(io.StringIO()):
            res = run.main([*MINIBATCH_ARGS, *extra, "--n_epochs", str(MINIBATCH_EPOCHS)])
        counts = {k: v for k, v in _all_counters().items() if v}
        trial = res["trials"][0]
        losses = trial["epoch_loss"]
        check(trial["epochs"] == MINIBATCH_EPOCHS and all(np.isfinite(losses)),
              f"{name}: {MINIBATCH_EPOCHS} epochs of finite losses")
        check(trial["test_acc"] > 2 / 16, f"{name}: test_acc above 2/16")
        check(trial["device_sampling"] and trial["exact_eval"] == ("--exact_eval" in extra),
              f"{name}: the device branch ran")
        if "--exact_eval" in extra:
            check(counts.get("K1 fwd", 0) > 0 and set(counts) == {"K1 fwd"},
                  f"{name}: exact inference launched K1, and nothing else ran: {counts}")
        else:
            check(not counts, f"{name}: no kernel launch on the path, got {counts}")
        print(f"[20 cli] {name}: loss {' -> '.join(f'{v:.4f}' for v in losses)}, test_acc "
              f"{trial['test_acc']:.4f}, epoch s {[round(v, 3) for v in trial['epoch_s']]},"
              f" total_s {trial['total_s']:.3f}, launches {counts}")
        out[name] = {"test_acc": trial["test_acc"], "epoch_loss": losses,
                     "epoch_s": trial["epoch_s"], "launches": counts}
    return out


def phase_flagship(data) -> dict:
    """Phase 20: the flagship path. On the headline bench's data (2.4M nodes,
    ``bench.flagship_data``): the sampler on the card against the CPU, graph replays
    against eager steps, the epoch timed in turns and profiled, then the bench's
    ``main`` on the same data (without its full-graph step, which phase 12 runs);
    then the CLI's device-sampling runs on the slices' graph."""
    import os

    from dgll_tpu_torch import bench

    t0 = time.perf_counter()
    _flagship_sampler(data)
    result = {"graph_vs_eager": _flagship_graph_vs_eager(data),
              "turns": _flagship_turns(data)}
    os.environ["BENCH_FULLGRAPH"] = "0"
    result["bench"] = bench.main(["--device", "cuda"], data=data)
    check(result["bench"]["detail"]["cuda_graph"], "the bench replayed a CUDA graph")
    result["cli"] = _flagship_cli()
    print(f"[20 done] phase 20 in {time.perf_counter() - t0:.1f} s")
    return result


# the packed host pipeline (phase 21): the configuration of
# benchmarks/epoch_bench.py:335-411 (EB_HOST=1) on the bench's data, each epoch's ms a
# batch including the host's sampling; (name, group, packed, CUDA graph), timed in
# turns A B C D E E D C B A. The eager packed run against the unpacked one is two
# copies a batch against eight, with the same eager step; the graph replays against
# the eager packed run are the graph's share.
HOST_GROUP = 8  # epoch_bench.py's BENCH_GROUP default
HOST_RUNS = (("host_pipeline_packed", 1, True, None),
             ("host_pipeline_packed_grouped", HOST_GROUP, True, None),
             ("host_pipeline_packed_auto", "auto", True, None),
             ("host_pipeline_packed_eager", 1, True, False),
             ("host_pipeline_unpacked", 1, False, False))
PACKED_BATCHES = 8  # the checks' batches, sampled once
PACKED_TOL = 1e-5   # group 3 with a padded tail against group 1, x max|ref|
# the CLI's --preprocess runs (phase 21) on the slices' graph, MINIBATCH_EPOCHS each
PREPROCESS_RUNS = (("GraphSAGE, --preprocess", ["--Model", "GraphSAGE", "--preprocess"]),
                   ("GraphSAGE, --preprocess --device_sampling",
                    ["--Model", "GraphSAGE", "--preprocess", "--device_sampling"]))


def _params(state) -> list:
    return [p.detach().clone() for p in state.model.parameters()]


def _packed_checks(data, hg) -> dict:
    """On ``PACKED_BATCHES`` batches sampled once on the host and moved to the card,
    from the same weights and generator seed, at dropout 0 and 0.5: the packed step
    replayed as a CUDA graph against the eager packed step (losses and parameters
    bitwise equal), and ``run_epoch_packed`` in groups of 3 (the last group padded)
    against groups of 1 (within ``PACKED_TOL`` x max|ref|)."""
    from dgll_tpu_torch import bench
    from dgll_tpu_torch.sampling import NeighborSampler
    from dgll_tpu_torch.tools.profile_slice import host_packed_trainer
    from dgll_tpu_torch.train import make_packed_block_step

    sampler = NeighborSampler(bench.FANOUTS, seed=3)
    nodes = data.train_nodes[: PACKED_BATCHES * 1024].reshape(PACKED_BATCHES, 1024)
    batches = [tuple(torch.from_numpy(a).cuda() for a in sampler.sample_packed(hg, b, 1024))
               for b in nodes]
    out = {}
    for dropout in (0.0, 0.5):
        runs = []
        for graph in (True, False):
            tr, state = host_packed_trainer(data, dropout, cuda_graph=graph)
            step = make_packed_block_step(bench.FANOUTS, cuda_graph=graph)
            losses = torch.stack([step(state, ids, mask, data.feats, data.labels,
                                       tr.generator)[1] for ids, mask in batches])
            runs.append((losses, _params(state)))
        (lg, pg), (le, pe) = runs
        check(torch.isfinite(lg).all().item(), "finite packed losses")
        check(torch.equal(lg, le) and all(torch.equal(a, b) for a, b in zip(pg, pe)),
              f"dropout {dropout}: {PACKED_BATCHES} packed graph replays bitwise equal to "
              "eager packed steps")
        runs = []
        for group in (1, 3):
            tr, state = host_packed_trainer(data, dropout)
            _, loss, _ = tr.run_epoch_packed(state, batches, data.feats, data.labels,
                                             bench.FANOUTS, group=group)
            check(tr.last_group == group and state.step == PACKED_BATCHES,
                  f"group {group} ran {PACKED_BATCHES} steps")
            runs.append((loss, _params(state)))
        (l1, p1), (l3, p3) = runs
        err_l = abs(l3 - l1)
        err_p = max((a - b).abs().max().item() for a, b in zip(p3, p1))
        scale = max(b.abs().max().item() for b in p1)
        check(err_l <= PACKED_TOL * abs(l1) and err_p <= PACKED_TOL * scale,
              f"dropout {dropout}: group 3 with a padded tail within {PACKED_TOL} x "
              "max|ref| of group 1")
        out[f"dropout {dropout}"] = {"graph_vs_eager": "bitwise equal",
                                     "group3_vs_group1": {"loss": err_l, "params": err_p}}
        print(f"[21 check] dropout {dropout}: {PACKED_BATCHES} packed graph replays "
              f"bitwise equal to eager steps (losses {' '.join(f'{v:.6f}' for v in lg.tolist())}); "
              f"group 3 (padded tail) against group 1: max abs error loss {err_l:.3e}, "
              f"parameters {err_p:.3e}")
    return out


def _host_turns(data, hg) -> dict:
    """``HOST_RUNS``, each from the bench's weights after a warm-up epoch on a short
    loader (the captures), timed in turns: ms a batch of each epoch, host clock, the
    epoch ending in its read of the loss."""
    from dgll_tpu_torch.tools.profile_slice import host_packed_loader, host_packed_trainer

    _zero_all_counters()
    runs = {}
    for name, group, packed, graph in HOST_RUNS:
        tr, state = host_packed_trainer(data, cuda_graph=graph)
        short = data.train_nodes[: 2 * HOST_GROUP * 1024]
        loader = host_packed_loader(data, hg, packed=packed)
        runs[name] = (tr, state, group, packed, loader)
        _host_epoch(runs[name], data, host_packed_loader(data, hg, short, 1, packed))

    out = {name: [] for name in runs}
    for name in [*runs, *reversed(runs)]:
        out[name].append(_host_epoch(runs[name], data))
    counts = {k: v for k, v in _all_counters().items() if v}
    check(not counts, f"the host pipeline launches no kernel of the port, got {counts}")
    tr = runs["host_pipeline_packed_auto"][0]
    bw, rtt = tr._link
    result = {name: {"ms_per_batch": float(np.median(v)), "epochs": v} for name, v in out.items()}
    result["host_pipeline_packed_auto"].update(
        chosen_group=tr.last_group, probed_bandwidth_mb_s=bw / 1e6, probed_rtt_ms=rtt * 1e3)
    result["host_pipeline_packed_grouped"]["group"] = HOST_GROUP
    n_batches = len(runs["host_pipeline_packed"][4])
    for name, r in result.items():
        extra = ""
        if name == "host_pipeline_packed_auto":
            extra = (f", chosen group {r['chosen_group']}, probed bandwidth "
                     f"{r['probed_bandwidth_mb_s']:.1f} MB/s, RTT {r['probed_rtt_ms']:.4f} ms")
        print(f"[21 turns] {name}: {r['ms_per_batch']:.4f} ms a batch including sampling "
              f"(median of {' / '.join(f'{v:.4f}' for v in r['epochs'])}, {n_batches} "
              f"batches an epoch){extra}")
    result["profile"] = _host_profile(runs["host_pipeline_packed"], data)
    result["sample_packed_ms"] = _sample_ms(data, hg)
    return result


def _sample_ms(data, hg, batches: int = 10) -> float:
    """ms of one ``sample_packed`` of a 1,024-seed batch on one host thread, the mean
    of ``batches`` after one warm-up: the producers' work a batch."""
    from dgll_tpu_torch import bench
    from dgll_tpu_torch.sampling import NeighborSampler

    sampler = NeighborSampler(bench.FANOUTS, seed=5)
    seeds = data.train_nodes[: (batches + 1) * 1024].reshape(batches + 1, 1024)
    sampler.sample_packed(hg, seeds[0], 1024)
    t0 = time.perf_counter()
    for b in seeds[1:]:
        sampler.sample_packed(hg, b, 1024)
    ms = (time.perf_counter() - t0) * 1e3 / batches
    print(f"[21 sample] sample_packed on one host thread: {ms:.4f} ms a batch of 1,024 "
          f"seeds ({1024 * 11 * 16} ids)")
    return ms


def _host_epoch(run, data, loader=None) -> float:
    """One epoch of ``run`` (``_host_turns``' tuple) over ``loader`` (its own by
    default): ms a batch on the host clock."""
    from dgll_tpu_torch import bench

    tr, state, group, packed, own = run
    loader = own if loader is None else loader
    t0 = time.perf_counter()
    if packed:
        _, loss, _ = tr.run_epoch_packed(state, loader, data.feats, data.labels,
                                         bench.FANOUTS, group=group)
    else:
        _, loss, _ = tr.run_epoch(state, loader, data.feats, data.labels)
    ms = (time.perf_counter() - t0) * 1e3 / len(loader)
    check(np.isfinite(loss), "a finite epoch loss")
    return ms


def _host_profile(run, data) -> dict:
    """``profile_slice --host_packed``'s numbers for the packed run."""
    from dgll_tpu_torch.tools import profile_slice

    tr, state, _, _, loader = run
    res = profile_slice.host_packed_profile(tr, state, loader, data)
    per = res["ms_per_batch"]
    print(f"[21 profile] one packed epoch: wall {per['wall']:.4f} ms a batch, device busy "
          f"{per['busy']:.4f}, idle {100 * res['profile']['idle_share']:.2f}%; top kernels "
          + ", ".join(f"{100 * v['share']:.1f}% {k[:60]}" for k, v in
                      list(res["profile"]["kernels"].items())[:5]))
    return res


def _pipelined_trainer() -> dict:
    """One epoch of ``MQTrainer`` (``PipelinedTrainer``) with the CLI's
    ``--cached_nPercent 25`` cache on the slices' graph (GraphSAGE, hidden 256,
    fanouts [10, 5], batch 1024), and its validation."""
    from dgll_tpu_torch import run
    from dgll_tpu_torch.cache import HBMFeatureCache
    from dgll_tpu_torch.train import MQTrainer
    from dgll_tpu_torch.utils import parse_train_config

    cfg = parse_train_config([*MINIBATCH_ARGS, "--Model", "GraphSAGE",
                              "--cached_nPercent", "25"])
    g = run.build_dataset(cfg)
    host = g.node_feat.numpy()
    cache = HBMFeatureCache(host, device="cuda")
    k = int(cfg.cached_percent / 100.0 * g.n_real_node)
    cache.auto_cache(g.out_degrees_np(), k * host.shape[1] * host.itemsize)
    n_class = int(g.labels[: g.n_real_node].max()) + 1
    model = run.build_model(cfg, n_class, host.shape[1],
                            generator=torch.Generator().manual_seed(0))
    tr = MQTrainer(model, run.make_optimizer(cfg), g, run.build_sampler(cfg),
                   cfg.batch_size, cache, g.labels, device="cuda").init(g.get_train_nodes())
    res = tr.fit(g.get_train_nodes(), g.get_validation_nodes(), epochs=1)
    phases, loss = res["phases"], res["history"][0]["loss"]
    n_batches = -(-len(g.get_train_nodes()) // cfg.batch_size)
    check(np.isfinite(loss) and {"load", "compute"} <= set(phases),
          "PipelinedTrainer: a finite loss, load and compute timed")
    check(cache.k == 50_000 and 0 < res["cache_miss_rate"] < 1,
          "PipelinedTrainer: the cache holds 25% of the rows and misses some")
    print(f"[21 pipelined] MQTrainer, cache 25%: one epoch of {n_batches} batches in "
          f"{res['history'][0]['s']:.3f} s, loss {loss:.4f}, val {res['best_val']:.4f}; "
          f"host time a batch: load {1e3 * phases['load'] / n_batches:.3f} ms, compute "
          f"{1e3 * phases['compute'] / n_batches:.3f} ms; cache_miss_rate "
          f"{res['cache_miss_rate']:.4f}")
    return {"epoch_s": res["history"][0]["s"], "loss": loss, "best_val": res["best_val"],
            "load_ms_per_batch": 1e3 * phases["load"] / n_batches,
            "compute_ms_per_batch": 1e3 * phases["compute"] / n_batches,
            "cache_miss_rate": res["cache_miss_rate"]}


def _fused_gcn() -> dict:
    """``fused_gcn_layer`` forward and backward on the card against the same on the
    CPU (plain PyTorch both), on the slices' GCN graph (normalised weights) at width
    128, within 1e-4 x max|ref|; then timed on the card beside the autograd
    composition ``relu(spmm_coo(x @ w))``.

    The card's ``index_add_`` sums in atomic order, the CPU's in edge order, so a
    pre-activation within float32 rounding of 0 may fall on either side of the
    ReLU, and the backward's mask with it: the cotangent is zeroed where the
    pre-activation (float64, on the card) lies within 1e-4 x its max of 0, so that
    both devices mask the same elements."""
    from dgll_tpu_torch import run
    from dgll_tpu_torch.ops import fused_gcn_layer, spmm_coo
    from dgll_tpu_torch.utils import parse_train_config
    from dgll_tpu_torch.utils.profiling import cuda_median_ms

    g = run.build_dataset(parse_train_config([*MINIBATCH_ARGS, "--Model", "GCN"]))
    gen = torch.Generator().manual_seed(21)
    n, f = g.n_node, 128
    x, cot = torch.randn(n, f, generator=gen), torch.randn(n, f, generator=gen)
    w = torch.randn(f, f, generator=gen) / f ** 0.5
    edges = (g.src, g.dst, g.edge_weight)
    agg = spmm_coo(g.src.cuda(), g.dst.cuda(), x.cuda().double() @ w.cuda().double(), n,
                   g.edge_weight.cuda().double())
    kink = (agg.abs() <= 1e-4 * agg.abs().max()).cpu()
    cot = torch.where(kink, 0.0, cot)

    def layer(dev, fn=fused_gcn_layer):
        xs, ws = x.to(dev).requires_grad_(), w.to(dev).requires_grad_()
        e = [t.to(dev) for t in edges]
        return xs, ws, e, lambda: fn(*e, xs, ws, n)

    out = {}
    for dev in ("cuda", "cpu"):
        xs, ws, _, fwd = layer(dev)
        y = fwd()
        y.backward(cot.to(dev))
        out[dev] = [t.detach().cpu() for t in (y, xs.grad, ws.grad)]
    errs = {}
    for name, got, want in zip(("out", "grad_x", "grad_w"), out["cuda"], out["cpu"]):
        errs[name] = (got - want).abs().max().item()
        check(errs[name] <= 1e-4 * want.abs().max().item(),
              f"fused_gcn_layer {name}: card within 1e-4 x max|ref| of the CPU")
    cot_d = cot.cuda()
    times = {}
    for name, fn in (("fused", fused_gcn_layer),
                     ("autograd", lambda s, d, ew, xs, ws, n_dst: torch.relu(
                         spmm_coo(s, d, xs @ ws, n_dst, ew)))):
        xs, ws, _, fwd = layer("cuda", fn)
        times[name] = cuda_median_ms(lambda: fwd().backward(cot_d))
    print(f"[21 fused_gcn] fused_gcn_layer on the slices' graph ({n} nodes, {g.n_edge} edges, "
          f"width {f}; {int(kink.sum())} cotangents at the ReLU's kink zeroed): card "
          f"against CPU max abs error out {errs['out']:.3e}, grad_x "
          f"{errs['grad_x']:.3e}, grad_w {errs['grad_w']:.3e}; forward + backward "
          f"{times['fused']:.4f} ms, autograd composition {times['autograd']:.4f} ms")
    return {"max_abs_err": errs, "fwd_bwd_ms": times, "kink_zeroed": int(kink.sum())}


def _preprocess_cli() -> dict:
    """The CLI's ``PREPROCESS_RUNS`` on the slices' graph, every counter set to 0 just
    before each and read just after (the path launches no kernel of the port)."""
    from dgll_tpu_torch import run

    out = {}
    for name, extra in PREPROCESS_RUNS:
        _zero_all_counters()
        with contextlib.redirect_stdout(io.StringIO()):
            res = run.main([*MINIBATCH_ARGS, *extra, "--n_epochs", str(MINIBATCH_EPOCHS)])
        counts = {k: v for k, v in _all_counters().items() if v}
        trial = res["trials"][0]
        losses = trial["epoch_loss"]
        check(trial["epochs"] == MINIBATCH_EPOCHS and all(np.isfinite(losses)),
              f"{name}: {MINIBATCH_EPOCHS} epochs of finite losses")
        check(trial["preprocess"] is True and trial["test_acc"] > 2 / 16,
              f"{name}: preprocessed, test_acc above 2/16")
        check(not counts, f"{name}: no kernel launch on the path, got {counts}")
        print(f"[21 cli] {name}: loss {' -> '.join(f'{v:.4f}' for v in losses)}, test_acc "
              f"{trial['test_acc']:.4f}, epoch s {[round(v, 3) for v in trial['epoch_s']]},"
              f" total_s {trial['total_s']:.3f}")
        out[name] = {"test_acc": trial["test_acc"], "epoch_loss": losses,
                     "epoch_s": trial["epoch_s"]}
    return out


CAPTURE_TRIES = 5  # captures of a step beside a thread that pins, allocates and copies


def _capture_beside_producers() -> dict:
    """``CAPTURE_TRIES`` steps captured as CUDA graphs while another thread does what
    a loader's producers do (``PinnedRing.copy`` of a new length each time: a new
    pinned buffer, an allocation on the card, a copy, an event): every capture must
    hold and the thread must see no error. In CUDA's global capture mode such a call
    from another thread invalidates the capture, depending on when it lands."""
    import threading

    from dgll_tpu_torch.dataloader.dataloader import PinnedRing
    from dgll_tpu_torch.train.cuda_graph import GRAPH_ADAM, GraphedStep
    from dgll_tpu_torch.train.trainer import TrainState

    dev = torch.device("cuda")
    ring, stop, errors, copies = PinnedRing(4), threading.Event(), [], [0]

    def producer():
        rng = np.random.default_rng(0)
        try:
            while not stop.is_set():
                n = int(rng.integers(1, 1 << 16))
                ring.copy([rng.standard_normal(n, dtype=np.float32)], dev)
                copies[0] += 1
        except Exception as e:  # reported by the check below
            errors.append(repr(e))

    def body(state, generator, inputs):
        (x,) = inputs
        loss = state.model(x).square().mean()
        loss.backward()
        state.optimizer.step()
        return (loss,)

    thread = threading.Thread(target=producer)
    thread.start()
    losses = []
    try:
        while not copies[0] and not errors:
            time.sleep(1e-3)
        for i in range(CAPTURE_TRIES):
            model = torch.nn.Linear(256, 256).to(dev)
            state = TrainState(model, torch.optim.Adam(model.parameters(), **GRAPH_ADAM))
            x = torch.ones(1024, 256, device=dev)
            (loss,) = GraphedStep(body, True)(state, torch.Generator(dev).manual_seed(i), (x,))
            losses.append(loss.item())
    finally:
        stop.set()
        thread.join()
    check(not errors, f"the producer thread saw no error, got {errors}")
    check(all(np.isfinite(losses)), f"finite losses from the replays, got {losses}")
    print(f"[21 capture] {CAPTURE_TRIES} captures held beside a thread that made "
          f"{copies[0]} pinned copies meanwhile")
    return {"captures": CAPTURE_TRIES, "producer_copies": copies[0]}


def phase_host_packed(data) -> dict:
    """Phase 21: the packed host pipeline on the headline bench's data (2.4M nodes,
    shared with phase 20): captures beside a producer thread
    (``_capture_beside_producers``), the packed step's graph against its eager step
    and groups against single steps (``_packed_checks``), the runs of ``HOST_RUNS`` in
    turns and one packed epoch profiled (``_host_turns``); then, on the slices' graph,
    ``PipelinedTrainer`` with the cache, ``fused_gcn_layer`` against the CPU and the
    CLI's ``--preprocess`` runs."""
    from dgll_tpu_torch.sampling import HostGraph

    t0 = time.perf_counter()
    hg = HostGraph(data.indptr, data.src, data.n_node)
    result = {"capture_beside_producers": _capture_beside_producers(),
              "checks": _packed_checks(data, hg), "turns": _host_turns(data, hg)}
    del hg
    result["pipelined"] = _pipelined_trainer()
    result["fused_gcn"] = _fused_gcn()
    result["cli"] = _preprocess_cli()
    print(f"[21 done] phase 21 in {time.perf_counter() - t0:.1f} s")
    return result


# the layer-wise samplers and GIN (phase 22). On the bench's data: the configuration of
# benchmarks/epoch_bench.py:195-271 (bench.layerwise_runner), beside the reference's
# MQ-FastGCN+f+d batch time (bench.BASELINE_MS)
LAYERWISE_MODES = ("fastgcn", "ladies")
LAYERWISE_BATCHES = 8  # the graph-against-eager comparison's batches
# the CLI's layer-wise runs on the slices' graph (MINIBATCH_ARGS), MINIBATCH_EPOCHS
# each, at the epoch's layer sizes ([2048, 1024]: 1024 grown by 2 a layer outwards);
# the default model (GCN) with --exact_eval, whose exact inference launches K1
LAYERWISE_CLI_ARGS = ["--n_samp", "1024", "--samp_growth_rate", "2"]
LAYERWISE_CLI_RUNS = (
    ("FastGCN, host", ["--samp_type", "fastgcn"]),
    ("LADIES --flatten, host", ["--samp_type", "ladies", "--flatten"]),
    ("FastGCN --flatten, --device_sampling",
     ["--samp_type", "fastgcn", "--device_sampling", "--flatten"]),
    ("LADIES, --device_sampling --exact_eval",
     ["--samp_type", "ladies", "--device_sampling", "--exact_eval"]))
GIN_EPOCHS = 20  # the full-batch GIN run, as the GCN slice's
GIN_CLASSIFY = dict(n_graph=128, hidden=32, n_layers=3, pooling=("sum", "mean"),
                    dropout=0.1, lr=5e-3, epochs=100)  # examples/graph_classification_gin.py


def _ladies_ties(lap_cpu, prev_ids, prev_mask, u, got, want) -> int:
    """The LADIES draws of one layer that differ between the card and the CPU, each
    checked to lie within rounding of a boundary of the prefix sum: ``|u tot -
    cum[j]| <= nK 2^-52 tot`` for some ``j`` (the float64 bound of a sum of ``nK``
    non-negative terms: both sum in float64), ``cum`` in float64 on the host."""
    differ = np.flatnonzero(got != want)
    if len(differ) == 0:
        return 0
    prev_mask = prev_mask.numpy()
    safe = np.where(prev_mask, prev_ids.numpy(), 0)
    vals = lap_cpu.ell_val.numpy()[safe].astype(np.float64)
    vals[(lap_cpu.ell_col.numpy()[safe] < 0) | ~prev_mask[:, None]] = 0
    cum = np.cumsum((vals * vals).reshape(-1))
    tol = len(cum) * 2.0 ** -52 * cum[-1]
    for i in differ:
        check(np.abs(cum - u[i] * cum[-1]).min() <= tol,
              f"LADIES draw {i} differs off a boundary of the prefix sum")
    return len(differ)


def _layerwise_sampler(data, lap) -> dict:
    """Both layer-wise samplers on the card against the same function on the CPU,
    layer by layer from the CPU's previous layer, with the same uniforms (drawn on
    the CPU), on the flagship's Laplacian at the bench's sizes: 1,024 train seeds;
    seeds of in-degree 0 and every fifth masked. FastGCN: ids and slots exact,
    weights within 1e-6 relative (a slot's multiplicity enters its weight as a
    factor, so it is held exactly there); LADIES: a drawn id may differ only where
    its uniform lies within rounding of a prefix-sum boundary (counted), and a layer
    where none does is held as FastGCN's, its weights within 1e-5 relative (its
    column sums are a scatter in another order)."""
    from dgll_tpu_torch import bench
    from dgll_tpu_torch.sampling.device_layerwise import _layer, draw_layer_uniforms

    lap_cpu = lap.to("cpu")
    zero = np.flatnonzero(np.diff(data.indptr) == 0)[:64]
    b = 1024
    cases = {"train seeds": (data.train_nodes[:b], np.ones(b, bool)),
             "degree 0 and masked": (np.concatenate([zero, data.train_nodes[:b - len(zero)]]),
                                     np.arange(b) % 5 != 3)}
    gen = torch.Generator().manual_seed(22)
    out = {}
    for mode in LAYERWISE_MODES:
        ties = 0
        for name, (seeds, mask) in cases.items():
            prev_ids = torch.from_numpy(seeds.astype(np.int32))
            prev_mask = torch.from_numpy(mask)
            for li, s in enumerate(reversed(bench.LAYERWISE_SIZES)):
                d = draw_layer_uniforms(s, mode, gen)
                want = _layer(lap_cpu, prev_ids, prev_mask, s, d, mode)
                on_card = tuple(t.cuda() for t in d) if mode == "fastgcn" else d.cuda()
                got = _layer(lap, prev_ids.cuda(), prev_mask.cuda(), s, on_card, mode)
                n = len(prev_ids)
                ids_t, ids_c = got.src_ids.cpu().numpy(), want.src_ids.numpy()
                if mode == "ladies":
                    layer_ties = _ladies_ties(lap_cpu, prev_ids, prev_mask, d.numpy(),
                                              ids_t[n:], ids_c[n:])
                    ties += layer_ties
                    if layer_ties:
                        break  # the blocks differ from here on
                check(np.array_equal(ids_t, ids_c), f"{mode}, {name}, layer {li}: ids")
                check(torch.equal(got.slot.cpu(), want.slot), f"{mode}, {name}: slots")
                check(torch.equal(got.src_mask.cpu(), want.src_mask), f"{mode}: src_mask")
                rtol = 1e-6 if mode == "fastgcn" else 1e-5
                err = (got.weight.cpu() - want.weight).abs()
                check(bool((err <= rtol * want.weight.abs()).all()),
                      f"{mode}, {name}, layer {li}: weights within {rtol} relative")
                if name != "train seeds" and li == 0:
                    check(bool((got.weight.cpu()[torch.from_numpy(~mask)] == 0).all()),
                          f"{mode}: masked seeds carry no weight")
                prev_ids, prev_mask = want.src_ids, want.src_mask
        out[mode] = {"ladies_ties": ties} if mode == "ladies" else {}
        print(f"[22 sampler] {mode}: card == CPU on the flagship's Laplacian "
              f"({lap.n_node} nodes, ELL width {lap.k}), layer sizes "
              f"{bench.LAYERWISE_SIZES}: 1,024 train seeds; {len(zero)} seeds of "
              "in-degree 0 and every fifth masked"
              + (f"; draws differing at a prefix-sum tie: {ties}" if mode == "ladies"
                 else ""))
    return out


def _layerwise_graph_vs_eager(data, lap) -> dict:
    """``LAYERWISE_BATCHES`` batches of each sampler as graph replays and as eager
    steps, from the same weights, generator seed and draws; dropout 0 and 0.5."""
    from dgll_tpu_torch import bench
    from dgll_tpu_torch.train import draw_epoch

    nodes = data.train_nodes[: LAYERWISE_BATCHES * 1024]
    out = {}
    for mode in LAYERWISE_MODES:
        for dropout in (0.0, 0.5):
            draws = draw_epoch(LAYERWISE_BATCHES, 1024, bench.LAYERWISE_SIZES, False,
                               torch.Generator("cuda").manual_seed(22), "cuda", mode)
            runs = []
            for graph in (True, False):
                runner, state = bench.layerwise_runner(data, lap, mode, cuda_graph=graph,
                                                       dropout=dropout, train_nodes=nodes)
                runner.run_epoch(state, data.feats, data.labels, draws=draws)
                runs.append((runner.batch_losses.clone(), _params(state)))
            (lg, pg), (le, pe) = runs
            err_l = (lg - le).abs().max().item()
            err_p = max((a - b).abs().max().item() for a, b in zip(pg, pe))
            check(torch.isfinite(lg).all().item(), "finite losses")
            check(err_l <= GRAPH_TOL * le.abs().max().item(),
                  f"{mode}, dropout {dropout}: graph losses within {GRAPH_TOL} x max|ref|")
            check(err_p <= GRAPH_TOL * max(b.abs().max().item() for b in pe),
                  f"{mode}, dropout {dropout}: graph parameters within {GRAPH_TOL} x "
                  "max|ref|")
            out[f"{mode}, dropout {dropout}"] = {"max_abs_err_loss": err_l,
                                                 "max_abs_err_param": err_p}
            print(f"[22 graph] {mode}, dropout {dropout}: {LAYERWISE_BATCHES} replays "
                  f"against eager steps: losses "
                  f"{' '.join(f'{v:.6f}' for v in lg.tolist())}; max abs error loss "
                  f"{err_l:.3e}, parameters {err_p:.3e}")
    return out


def _layerwise_epochs(data, lap, smi: str) -> dict:
    """Each sampler's products-scale epoch (``bench.layerwise_runner``, uncut): ms a
    batch including sampling (the bench's timing: a warm-up epoch, the capture, then
    ``bench.TIMED_EPOCHS`` epochs ending in a read of the loss), beside
    ``bench.BASELINE_MS / ms`` as ``vs_dgll_products_batch``; the peak device memory
    of the run; then one epoch profiled and split into phases
    (``profile_slice --device_sampling --sampler``)."""
    from dgll_tpu_torch import bench
    from dgll_tpu_torch.tools import profile_slice

    out = {}
    for mode in LAYERWISE_MODES:
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        runner, state = bench.layerwise_runner(data, lap, mode)
        ms = bench.time_epochs(runner, state, data)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        check(runner.cuda_graph and all(np.isfinite(ms)), f"{mode}: a replayed epoch")
        res = profile_slice.device_sampling_profile(runner, state, data.feats, data.labels)
        per = res["ms_per_batch"]
        out[mode] = {"ms_per_batch": ms, "vs_dgll_products_batch": bench.BASELINE_MS / ms[-1],
                     "n_batches": runner.n_batches, "peak_gib_above_held": peak,
                     "idle_share": res["profile"]["idle_share"], "wall_busy": per,
                     "phases_ms_per_batch": res["phases_ms_per_batch"]}
        print(f"[22 epoch] {mode} ({smi}): GCN hidden {bench.SAGE_HIDDEN}, layer sizes "
              f"{bench.LAYERWISE_SIZES}, batch 1024, {runner.n_batches} batches: "
              f"{' / '.join(f'{v:.4f}' for v in ms)} ms a batch including sampling, "
              f"vs_dgll_products_batch {bench.BASELINE_MS / ms[-1]:.3f}; peak memory "
              f"{peak:.2f} GiB above the {held / 2**30:.2f} GiB held; profiled epoch: "
              f"wall {per['wall']:.4f} / busy {per['busy']:.4f} ms a batch, idle "
              f"{100 * res['profile']['idle_share']:.2f}%; phases (ms a batch) "
              + ", ".join(f"{k} {v:.4f}" for k, v in res["phases_ms_per_batch"].items()))
        del runner, state
    return out


def _cli_run(name: str, args: list) -> tuple:
    """One CLI run, every counter set to 0 just before it and read just after:
    ``(trial, launches)``."""
    from dgll_tpu_torch import run

    _zero_all_counters()
    with contextlib.redirect_stdout(io.StringIO()):  # the CLI's own JSON line
        res = run.main(args)
    counts = {k: v for k, v in _all_counters().items() if v}
    trial = res["trials"][0]
    check(all(np.isfinite(trial["epoch_loss"])), f"{name}: finite losses")
    check(trial["test_acc"] > 2 / 16, f"{name}: test_acc above 2/16")
    return trial, counts


def _layerwise_cli() -> dict:
    """``LAYERWISE_CLI_RUNS``: exact inference launches K1 (one forward a layer), and
    nothing else launches a kernel of the port."""
    out = {}
    for name, extra in LAYERWISE_CLI_RUNS:
        trial, counts = _cli_run(name, [*MINIBATCH_ARGS, *LAYERWISE_CLI_ARGS, *extra,
                                        "--n_epochs", str(MINIBATCH_EPOCHS)])
        device = "--device_sampling" in extra
        check(trial["epochs"] == MINIBATCH_EPOCHS, f"{name}: {MINIBATCH_EPOCHS} epochs")
        check(trial.get("device_sampling", False) == device,
              f"{name}: the {'device' if device else 'host'} path")
        if "--exact_eval" in extra:
            check(counts == {"K1 fwd": 2}, f"{name}: exact inference launched K1 once a "
                                            f"layer, and nothing else ran: {counts}")
        else:
            check(not counts, f"{name}: no kernel launch on the path, got {counts}")
        print(f"[22 cli] {name}: loss "
              f"{' -> '.join(f'{v:.4f}' for v in trial['epoch_loss'])}, test_acc "
              f"{trial['test_acc']:.4f}, epoch s {[round(v, 3) for v in trial['epoch_s']]}"
              f", total_s {trial['total_s']:.3f}, launches {counts}")
        out[name] = {k: trial[k] for k in ("test_acc", "epoch_loss", "epoch_s", "total_s")}
        out[name]["launches"] = counts
    return out


def _gin_cli(smi: str) -> dict:
    """``--Model GIN --samp_type full`` for ``GIN_EPOCHS`` epochs on the slices' graph
    (the CLI tries the windowed layout and declines it, as for GCN): K1's launches
    against the count the model gives (an epoch: 2 forward and 1 backward in training,
    the first layer's input being the features, which need no gradient; 2 forward in
    validation; 2 forward in the final test), the steady epoch time and the test
    accuracy; then ``--Model GIN --device_sampling``, which launches no kernel."""
    from dgll_tpu_torch import run
    from dgll_tpu_torch.tools.profile_slice import SLICE_ARGS

    trial, counts = _cli_run("GIN, full", [*SLICE_ARGS, "--Model", "GIN", "--n_epochs",
                                           str(GIN_EPOCHS)])
    e = trial["epochs"]
    want = {"K1 fwd": 4 * e + 2, "K1 bwd": e}
    check(e == GIN_EPOCHS and trial["spmm_kernel"] == run.SPMM_KERNEL,
          f"GIN: {GIN_EPOCHS} epochs through K1")
    check(counts == want, f"GIN: K1 launched {want}, got {counts}")
    losses, secs = trial["epoch_loss"], trial["epoch_s"]
    check(losses[-1] < losses[0], "GIN: the last loss is below the first")
    steady = 1e3 * float(np.mean(secs[1:]))
    print(f"[22 gin] full batch ({smi}): {e} epochs, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, test_acc {trial['test_acc']:.4f}, steady epoch "
          f"{steady:.3f} ms (median {1e3 * float(np.median(secs[1:])):.3f}), "
          f"layout_preprocess_s {trial['layout_preprocess_s']:.3f}, K1 launches {counts} "
          f"(4 x {e} + 2 forward, {e} backward)")
    out = {"full": {"test_acc": trial["test_acc"], "epoch_loss": losses, "epoch_s": secs,
                    "steady_epoch_ms": steady, "launches": counts}}
    name = "GIN, --device_sampling"
    trial, counts = _cli_run(name, [*MINIBATCH_ARGS, "--Model", "GIN", "--device_sampling",
                                    "--n_epochs", str(MINIBATCH_EPOCHS)])
    check(trial["device_sampling"] and not counts, f"{name}: the device path, no launch")
    print(f"[22 gin] {name}: loss {' -> '.join(f'{v:.4f}' for v in trial['epoch_loss'])}, "
          f"test_acc {trial['test_acc']:.4f}, epoch s "
          f"{[round(v, 3) for v in trial['epoch_s']]}")
    out["device_sampling"] = {k: trial[k] for k in ("test_acc", "epoch_loss", "epoch_s")}
    return out


def _gin_classify() -> dict:
    """GIN graph classification as ``examples/graph_classification_gin.py`` sets it up
    (``GIN_CLASSIFY``) on ``synthetic_graph_classification``'s 128 graphs batched into
    one graph with the kernel layouts: the forward on the card against the CPU's (the
    plain COO sum) from the same weights, within ``GIN_TOL`` x max|ref|, then the
    example's training with every K1 launch counted (a step: one forward a layer, one
    backward for each layer but the first), the loss falling."""
    from dgll_tpu_torch.data import synthetic_graph_classification
    from dgll_tpu_torch.nn import GIN, batch_graphs

    c = GIN_CLASSIFY
    g, gid, y = batch_graphs(synthetic_graph_classification(n_graph=c["n_graph"]))
    n, feat = c["n_graph"], g.node_feat.shape[1]
    model = GIN(feat, c["hidden"], 2, n_layers=c["n_layers"], pooling=c["pooling"],
                dropout=c["dropout"], generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        want = model(g, g.node_feat, gid, n)
    gc, gidc, yc = g.with_chunked().to("cuda"), gid.cuda(), y.cuda().long()
    model.cuda()
    _zero_all_counters()
    with torch.no_grad():
        got = model(gc, gc.node_feat, gidc, n).cpu()
    err = (got - want).abs().max().item()
    check(err <= GIN_TOL * want.abs().max().item(),
          f"GIN classifier: card within {GIN_TOL} x max|ref| of the CPU")
    opt = torch.optim.Adam(model.parameters(), lr=c["lr"])
    gen = torch.Generator("cuda").manual_seed(1)
    model.train()
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(c["epochs"]):
        opt.zero_grad(set_to_none=True)
        loss = -model(gc, gc.node_feat, gidc, n, generator=gen).gather(1, yc[:, None]).mean()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    losses = torch.stack(losses).tolist()
    step_ms = 1e3 * (time.perf_counter() - t0) / c["epochs"]
    model.eval()
    with torch.no_grad():
        acc = (model(gc, gc.node_feat, gidc, n).argmax(-1) == yc).float().mean().item()
    counts = {k: v for k, v in _all_counters().items() if v}
    layers, steps = c["n_layers"], c["epochs"]
    want_counts = {"K1 fwd": layers * (steps + 2), "K1 bwd": (layers - 1) * steps}
    check(counts == want_counts, f"GIN classifier: K1 launched {want_counts}, got {counts}")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          "GIN classifier: the loss falls")
    print(f"[22 gin] graph classification ({n} graphs, {g.n_real_node} nodes, width "
          f"{c['hidden']}, {layers} layers, {'+'.join(c['pooling'])} pooling): card "
          f"against CPU max abs error {err:.3e}; {steps} Adam steps {step_ms:.3f} ms a "
          f"step, loss {losses[0]:.4f} -> {losses[-1]:.4f}, train accuracy {acc:.4f}; "
          f"K1 launches {counts}")
    return {"max_abs_err": err, "step_ms": step_ms, "losses": [losses[0], losses[-1]],
            "train_acc": acc, "launches": counts}


def phase_layerwise(data, smi: str) -> dict:
    """Phase 22: the layer-wise samplers and GIN. On the headline bench's data (shared
    with phases 20 and 21): ``build_device_lap`` timed, the samplers on the card
    against the CPU, graph replays against eager steps and the products-scale epochs;
    then, on the slices' graph, the CLI's layer-wise runs, GIN's full-batch and device
    runs, and GIN graph classification."""
    from dgll_tpu_torch import bench

    t0 = time.perf_counter()
    lap = bench.layerwise_lap(data)
    build_s = time.perf_counter() - t0
    print(f"[22 lap] build_device_lap on the flagship graph ({data.n_node} nodes, "
          f"{len(data.src)} edges, ELL width {lap.k}): {build_s:.3f} s")
    result = {"build_device_lap_s": build_s,
              "sampler": _layerwise_sampler(data, lap),
              "graph_vs_eager": _layerwise_graph_vs_eager(data, lap),
              "epochs": _layerwise_epochs(data, lap, smi)}
    del lap
    result["cli"] = _layerwise_cli()
    result["gin"] = _gin_cli(smi)
    result["gin_classify"] = _gin_classify()
    print(f"[22 done] phase 22 in {time.perf_counter() - t0:.1f} s")
    return result


# phase 23: GAT in bfloat16, the dataset files, checkpoints and device_trace
BF16_SLICE_ARGS = ["--dtype", "bfloat16"]   # appended to the GAT slice's arguments
BF16_DEVICE_ARGS = ["--Model", "GAT", "--device_sampling", "--dtype", "bfloat16",
                    "--nhid", "8", "--n_heads", "8", "--dropout", "0.6", "--lr", "0.005",
                    "--weight_decay", "0.0005", "--n_epochs", "2"]
K7_BF16 = "expand_rows (K7) on bfloat16 rows: the bf16 GAT backward's expand"
K1_BF16 = ("spmm_csr (K1) on bfloat16 messages with runtime columns and unit weights: "
           "the bf16 GAT aggregation and scatter")
# K1's bfloat16 route: the widths checked (the bf16 GAT's 64 and 16, and 12: 4 columns
# a lane), of them those timed, and the widths of its general case
K1_BF16_WIDTHS = (64, 16, 12)
K1_BF16_TIMED = (64, 16)
K1_BF16_GENERAL_WIDTHS = (16, 64, 128)
TRACE_EPOCHS = 2


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at ``|x|`` (8 significant bits)."""
    mag = x.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _bf16_sum_bound(lay, cols, msg) -> tuple:
    """``(sum, tolerance)`` of K1's unit-weight sum of bfloat16 messages, per output:
    the float64 sum, and 1 bfloat16 ulp of it plus the bound on the float32 sum's
    error in K1's own order, ``d 2^-24 sum|x|`` for a summation ``d`` adds deep. A
    row of n edges is ``n`` deep; a split row (n > T = ``split.max_edges``) is at
    most ``T`` deep in a segment and ``n_seg`` more in pass 2, which adds the
    segments' float32 partials. A partial dropped, doubled or rounded to bf16 lies
    far outside it."""
    rows, idx = lay.rows.long(), cols.long()
    x = msg.double().index_select(0, idx)
    shape = (lay.n_rows, msg.shape[1])
    exact = torch.zeros(shape, dtype=torch.float64, device="cuda").index_add_(0, rows, x)
    absum = torch.zeros(shape, dtype=torch.float64, device="cuda").index_add_(0, rows,
                                                                                x.abs())
    t = lay.split.max_edges
    deg = (lay.indptr[1:] - lay.indptr[:-1]).long()
    n_seg = torch.where(deg > t, (deg + t - 1) // t, 0)
    depth = (deg.clamp(max=t) + n_seg).double()[:, None]
    return exact, _bf16_ulp(exact) + depth * 2.0 ** -24 * absum


def _bf16_kernels() -> dict:
    """K7 on bfloat16 rows against its plain version (bitwise), aligned (16-byte units)
    and unaligned or F % 8 != 0 (an element a unit); K1's bfloat16 route on bfloat16
    messages (``_k1_bf16_checks``: identity columns on A and ``t_slot_perm`` columns
    on A^T, every width of ``K1_BF16_WIDTHS``, aligned and not, on the slices', the
    power-law, the planted and the tail layouts; ``_k1_bf16_general``: the layout's
    columns and weights with bias and ReLU); each kernel at GAT's widths 64 and 16 on
    the slices' graph timed in turns beside its plain version and library call.
    Returns the JSON rows' errors and times (K1's four rows in ``k1_rows``)."""
    from dgll_tpu_torch.ops import gat_csr, spmm_chunked_reference
    from dgll_tpu_torch.ops.cuda import gat_fused as gf
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_csr_cuda
    from dgll_tpu_torch.tools.profile_slice import bf16_sparse_mm

    c, ct, _ = slice_graph()
    gen = torch.Generator(device="cuda").manual_seed(23)
    bf = torch.bfloat16
    out = {"k7_err": 0.0, "k1_err": 0.0}
    for f in (64, 16, 12):
        flat = torch.randn(c.n_rows * f + 1, generator=gen, device="cuda").to(bf)
        for aligned in (True, False):
            a = (flat[:-1] if aligned else flat[1:]).view(c.n_rows, f)
            vec = gf.expand_vec(f, a, a)
            got, want = gf.expand_rows_cuda(c, a), a.index_select(0, c.rows)
            check(got.dtype == bf and torch.equal(got, want),
                  f"K7 bf16 F={f} {'aligned' if aligned else 'unaligned'}: bitwise equal")
            if f == 12 or not aligned:
                print(f"[23 check] K7 bf16 F={f}, {'aligned' if aligned else 'unaligned'} "
                      f"({vec} an element a unit): bitwise equal")
                continue
            case = Case(lambda: (gf.expand_rows_cuda(c, a),),
                        lambda: (gat_csr.expand_rows_reference(c, a),),
                        lambda: a.index_select(0, c.rows), (c.rows, a), 0)
            t = timed(case, (got,))
            print(f"[23 time] K7 bf16 F={f} ({vec} elements a unit): bitwise equal; "
                  f"{describe(t)}")
            if f == 64:
                out["k7"] = t
    out["k1_err"] = _k1_bf16_checks(gen)
    out["k1_general_err"] = _k1_bf16_general(c, gen)
    for f in K1_BF16_TIMED:
        msg = torch.randn(c.src.numel(), f, generator=gen, device="cuda").to(bf)
        for name, lay, cols in (("identity columns on A", c, None),
                                ("t_slot_perm columns on A^T", ct, c.t_slot_perm)):
            kind = dict(identity_cols=True) if cols is None else dict(cols=cols)
            idx = c.edge_ids if cols is None else cols
            ones = lay.unit_weight
            # the bytes the sum needs: the unit weights carry none, nor do the
            # identity columns (0..E-1); one add an edge and feature
            reads = (lay.indptr, msg) if cols is None else (lay.indptr, cols, msg)
            case = Case(lambda: (spmm_csr_cuda(lay, msg, unit_weights=True, **kind),),
                        lambda: (spmm_chunked_reference(lay, msg, cols=idx, weights=ones),),
                        bf16_sparse_mm(lay, idx, msg), reads, c.src.numel() * f)
            t = timed(case, case.kernel())
            print(f"[23 time] K1 bf16 F={f} {name}: {describe(t)}")
            out.setdefault("k1_rows", {})[f"F={f} {name}"] = t
    out["k1"] = out["k1_rows"]["F=64 identity columns on A"]
    return out


def _k1_bf16_layouts() -> list:
    """Phase 23's K1 layouts: ``(name, layout of A, layout of A^T or None)``: the
    slices' graph (hub rows, empty rows), the power-law test graph, the planted graph
    whose rows cross the split threshold, and the power-law graph with every residue
    of nnz % 4 (A only)."""
    c, ct, _ = slice_graph()
    out = [("slices' graph", c, ct)]
    for name, (a, at, _) in (("power-law graph", power_law_layouts()),
                             ("planted graph", planted_layouts())):
        out.append((name, a, at))
    for k, a in sorted(tail_layouts().items()):
        out.append((f"power-law graph, nnz % 4 = {k}", a, None))
    return out


def _plain_sum_bound(lay, cols, msg, exact) -> torch.Tensor:
    """The plain version's own bound on the float64 sum ``exact``: 1 bfloat16 ulp
    plus ``n 2^-24 sum|x|``, since ``index_add`` sums a row of n edges in any order."""
    rows = lay.rows.long()
    shape = (lay.n_rows, msg.shape[1])
    absum = torch.zeros(shape, dtype=torch.float64, device="cuda").index_add_(
        0, rows, msg.double().index_select(0, cols.long()).abs())
    deg = (lay.indptr[1:] - lay.indptr[:-1]).double()[:, None]
    return _bf16_ulp(exact) + deg * 2.0 ** -24 * absum


def _k1_bf16_case(lay, msg, cols, what: str) -> float:
    """K1's bfloat16 route summing ``msg`` with unit weights on ``lay`` (identity
    columns where ``cols`` is None), held: within ``_bf16_sum_bound`` of the float64
    sum; beside the plain version within that bound plus the plain version's own;
    bitwise repeatable; bitwise equal to the same route fed ``edge_ids`` and
    ``unit_weight`` as loaded columns and weights (an add equals ``fmaf(1, x, acc)``).
    Returns the max abs error against the float64 sum."""
    from dgll_tpu_torch.ops import spmm_chunked_reference
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_csr_cuda

    kind = dict(identity_cols=True) if cols is None else dict(cols=cols)
    idx = lay.edge_ids if cols is None else cols
    got = spmm_csr_cuda(lay, msg, unit_weights=True, **kind)
    again = spmm_csr_cuda(lay, msg, unit_weights=True, **kind)
    loaded = spmm_csr_cuda(lay, msg, cols=idx, weights=lay.unit_weight)
    exact, tol = _bf16_sum_bound(lay, idx, msg)
    err = (got.double() - exact).abs()
    plain = spmm_chunked_reference(lay, msg, cols=idx, weights=lay.unit_weight)
    off = (got.double() - plain.double()).abs()
    check(got.dtype == torch.bfloat16 and bool((err <= tol).all()),
          f"K1 bf16 {what}: within 1 bf16 ulp of the sum, beyond the bound of the f32 "
          f"sum in K1's segment order")
    check(bool((off <= tol + _plain_sum_bound(lay, idx, msg, exact)).all()),
          f"K1 bf16 {what}: beside the plain version within both sums' bounds")
    check(torch.equal(got, again), f"K1 bf16 {what}: bitwise repeatable")
    check(torch.equal(got, loaded),
          f"K1 bf16 {what}: the identity/unit cases equal loaded columns and weights")
    return err.max().item()


def _k1_bf16_checks(gen) -> float:
    """``_k1_bf16_case`` at every width of ``K1_BF16_WIDTHS``, on 16-byte-aligned
    messages and on messages one element off (an element a lane), with identity
    columns on A and ``t_slot_perm`` columns on A^T, on each of ``_k1_bf16_layouts``.
    Returns the max abs error against the float64 sum."""
    from dgll_tpu_torch.ops.cuda.segment_matmul import k1_route

    worst = 0.0
    for name, a, at in _k1_bf16_layouts():
        nnz, vecs = a.src.numel(), set()
        kinds = [("identity columns on A", a, None)]
        if at is not None:
            kinds.append(("t_slot_perm columns on A^T", at, a.t_slot_perm))
        for f in K1_BF16_WIDTHS:
            flat = torch.randn(nnz * f + 1, generator=gen, device="cuda").to(torch.bfloat16)
            for aligned in (True, False):
                msg = (flat[:-1] if aligned else flat[1:]).view(nnz, f)
                route = k1_route(msg, True, True)
                vecs.add((f, route.vec))
                for kname, lay, cols in kinds:
                    worst = max(worst, _k1_bf16_case(
                        lay, msg, cols, f"{name} F={f} {kname} (vec {route.vec})"))
        print(f"[23 check] K1 bf16 on the {name} ({nnz} edges; {_split_summary(a)}; "
              f"{a.items.n_items} runs of rows): {', '.join(k for k, *_ in kinds)} at "
              f"(F, vec) {sorted(vecs)}: within the bound of the float64 sum and beside "
              f"the plain version, bitwise repeatable, equal to loaded columns and weights")
    return worst


def _k1_bf16_general(c, gen) -> float:
    """K1's bfloat16 route with the layout's own columns and weights, bias and ReLU,
    stored in bfloat16 (phase 3's bar, |err| / max(|ref|, 1) <= 1e-2) and in float32
    (the msg_dtype path of ``spmm_chunked`` and ``spmm_hybrid``; float32's bar, 1e-4 x
    max|ref|: the inputs are exact in float32, only the order of the sums differs)
    against the plain version on the slices' graph, bitwise repeatable. Returns the
    max abs error."""
    from dgll_tpu_torch.ops import spmm_chunked_reference
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_csr_cuda

    worst = 0.0
    for f in K1_BF16_GENERAL_WIDTHS:
        x = torch.randn(c.n_cols, f, generator=gen, device="cuda").to(torch.bfloat16)
        b = torch.randn(f, generator=gen, device="cuda")
        for out_dtype in (torch.bfloat16, torch.float32):
            got = spmm_csr_cuda(c, x, b, "relu", out_dtype=out_dtype)
            again = spmm_csr_cuda(c, x, b, "relu", out_dtype=out_dtype)
            ref = spmm_chunked_reference(c, x, b, "relu", out_dtype=torch.float32)
            diff = (got.float() - ref).abs()
            ratio = ((diff / ref.abs().clamp_min(1.0)).max() / 1e-2
                     if out_dtype == torch.bfloat16 else diff.max() / (1e-4 * ref.abs().max()))
            what = f"K1 bf16 general F={f}, bias + ReLU, out {str(out_dtype)[6:]}"
            check(got.dtype == out_dtype and ratio.item() <= 1.0, f"{what}: within tolerance")
            check(torch.equal(got, again), f"{what}: bitwise repeatable")
            worst = max(worst, diff.max().item())
            print(f"[23 check] {what}: max abs err {diff.max().item():.3e}, "
                  f"{ratio.item():.3f} of tolerance, bitwise repeatable")
    return worst


def _bf16_gat_cli(f32: dict) -> dict:
    """The CLI's GAT slice in bfloat16 (20 epochs, every counter set to 0 just before
    and read just after), beside phase 9's float32 run; then a short bf16 GAT run
    through ``--device_sampling`` (dense blocks in the CUDA graph, no kernel on its
    path)."""
    from dgll_tpu_torch import run
    from dgll_tpu_torch.tools.profile_slice import GAT_SLICE_ARGS

    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_all_counters()
    with contextlib.redirect_stdout(io.StringIO()):
        res = run.main([*GAT_SLICE_ARGS, *BF16_SLICE_ARGS, "--n_epochs", str(EPOCHS)])
    counts = {k: v for k, v in _all_counters().items() if v}
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    trial = res["trials"][0]
    losses, secs = trial["epoch_loss"], trial["epoch_s"]
    check(trial["epochs"] == EPOCHS and all(np.isfinite(losses)),
          f"bf16 GAT: {EPOCHS} epochs of finite losses")
    check(losses[-1] < losses[0], "bf16 GAT: the last loss is below the first")
    check(trial["test_acc"] > 2 / 16, "bf16 GAT: test_acc above 2/16")
    for k in ("gat_bwd_softmax", "edges_to_rows_sum", "expand_rows"):
        check(counts.get(k) == 2 * EPOCHS, f"bf16 GAT: exactly 2 {k} launches an epoch")
    check(counts.get("gat_stats", 0) >= 2 * EPOCHS and counts.get("K1 fwd", 0) >= 2 * EPOCHS
          and counts.get("K1 bwd") == 2 * EPOCHS, f"bf16 GAT: K3 and K1 launched: {counts}")
    check(counts.get("K1 bf16 route") == counts["K1 fwd"] + counts["K1 bwd"],
          f"bf16 GAT: every K1 launch took the bfloat16 route: {counts}")
    ms = 1e3 * np.median(secs[1:])
    print(f"[23 gat bf16] {EPOCHS} epochs: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"test_acc {trial['test_acc']:.4f}, epoch ms median {ms:.3f} (float32, phase 9: "
          f"{f32['epoch_ms_median']:.3f}; {f32['epoch_ms_median'] / ms:.2f}x), peak "
          f"memory {peak:.2f} GiB above the {held / 2**30:.2f} GiB held (float32: "
          f"{f32['peak_gib']:.2f} GiB), test_acc float32 {f32['test_acc']:.4f}, "
          f"launches {counts}")
    _zero_all_counters()
    with contextlib.redirect_stdout(io.StringIO()):
        dev = run.main([*MINIBATCH_ARGS, *BF16_DEVICE_ARGS])["trials"][0]
    dev_counts = {k: v for k, v in _all_counters().items() if v}
    check(dev["device_sampling"] and all(np.isfinite(dev["epoch_loss"])),
          "bf16 GAT --device_sampling: finite losses")
    check(not dev_counts, f"bf16 GAT --device_sampling: no kernel launch, got {dev_counts}")
    print(f"[23 gat bf16 device] loss {' -> '.join(f'{v:.4f}' for v in dev['epoch_loss'])},"
          f" test_acc {dev['test_acc']:.4f}, epoch s "
          f"{[round(v, 3) for v in dev['epoch_s']]}")
    return {"launches": counts, "epoch_ms_median": ms, "peak_gib": peak,
            "test_acc": trial["test_acc"], "f32": f32,
            "device_sampling": {"epoch_loss": dev["epoch_loss"],
                                "test_acc": dev["test_acc"]}}


def _files_and_resume() -> dict:
    """``save_graph`` of the GAT slice's graph and ``load_graph`` of it (equal arrays);
    the bf16 GAT slice with ``--checkpoint_dir`` (2 epochs, step 2), its ``--resume``
    with no epoch (resumed from step 2, which it saves again bitwise equal: the
    parameters it restored are those saved), and a resume of 2 epochs on the saved
    graph inside ``device_trace``, whose trace must name K1 and K7."""
    import tempfile

    from dgll_tpu_torch import run
    from dgll_tpu_torch.data import load_graph, save_graph, synthetic_classification_graph
    from dgll_tpu_torch.tools.profile_slice import GAT_SLICE_ARGS
    from dgll_tpu_torch.utils import device_trace, parse_train_config

    cfg = parse_train_config(GAT_SLICE_ARGS)
    g = synthetic_classification_graph(
        n_node=cfg.n_node, avg_degree=cfg.avg_degree, n_class=cfg.n_class,
        feat_dim=cfg.feat_dim, power_law=1.0, seed=cfg.seed)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/slice.graph"
        t0 = time.perf_counter()
        save_graph(g, path)
        loaded = load_graph(path)
        out["save_load_s"] = time.perf_counter() - t0
        for f in ("indptr", "src", "dst", "node_feat", "labels", "train_mask"):
            check(torch.equal(getattr(loaded, f), getattr(g, f)), f"load_graph: {f} equal")
        ck = f"{tmp}/ckpt"
        args = [*GAT_SLICE_ARGS, *BF16_SLICE_ARGS, "--checkpoint_dir", ck]
        with contextlib.redirect_stdout(io.StringIO()):
            run.main([*args, "--n_epochs", "2"])
            saved = torch.load(f"{ck}/step_2.pt", weights_only=True)
            resumed = run.main([*args, "--n_epochs", "0", "--resume"])["trials"][0]
        again = torch.load(f"{ck}/step_2.pt", weights_only=True)
        check(resumed.get("resumed_from") == 2, "--resume: resumed from step 2")
        check(set(again) == set(saved) and all(torch.equal(again[k], saved[k])
                                               for k in saved),
              "--resume: the restored parameters equal those saved")
        _zero_all_counters()
        with device_trace(f"{tmp}/trace"), contextlib.redirect_stdout(io.StringIO()):
            traced = run.main([*args, "--dataset", path, "--resume",
                               "--n_epochs", str(TRACE_EPOCHS)])["trials"][0]
        counts = {k: v for k, v in _all_counters().items() if v}
        files = os.listdir(f"{tmp}/trace")
        check(len(files) == 1, f"device_trace wrote one trace file: {files}")
        text = open(f"{tmp}/trace/{files[0]}").read()
        check("spmm_bf16_kernel" in text and "expand_rows_kernel" in text,
              "the trace names K1 (its bfloat16 route) and K7")
        check(traced.get("resumed_from") == 2 and counts.get("expand_rows") == 2 * TRACE_EPOCHS,
              f"the traced run resumed and launched K7 twice an epoch: {counts}")
        out.update(trace_mib=len(text) / 2**20, resumed_from=resumed["resumed_from"],
                   traced_launches=counts, ckpt_steps=sorted(os.listdir(ck)))
    print(f"[23 files] save_graph + load_graph of the slice's graph "
          f"({g.n_node} nodes, {g.n_edge} edges) in {out['save_load_s']:.2f} s, equal; "
          f"--resume from step {out['resumed_from']}, the restored parameters equal; "
          f"device_trace of {TRACE_EPOCHS} epochs on the loaded graph: "
          f"{out['trace_mib']:.1f} MiB, names K1 and K7, launches {counts}; checkpoints "
          f"{out['ckpt_steps']}")
    return out


def phase_bf16(f32: dict) -> dict:
    """Phase 23: GAT in bfloat16 (K7 on bf16 rows, K1 on bf16 messages with runtime
    columns), the dataset files, checkpoints and ``device_trace``."""
    t0 = time.perf_counter()
    kernels = _bf16_kernels()
    cli = _bf16_gat_cli(f32)
    files = _files_and_resume()
    print(f"[23 done] in {time.perf_counter() - t0:.1f} s")
    return {"kernels": kernels, "cli": cli, "files": files}


# phase 24: data parallel and graph-partition parallel, two ranks sharing the card over
# gloo (launch_local); the ranks read their inputs from files under build/
PAR_DIR = os.path.join("build", "phase24")
PAR_RANKS = 2
PAR_BATCH = 512        # a rank's sub-batch: the flagship's 1,024 a global batch
PAR_TOL = 1e-5         # the ranks' parameters against one process, x max|ref|
PAR_GP_TOL = 1e-4      # the GP logits and step against one process: K1's f32 bar
PAR_GP_LR = 0.1        # one SGD step: the step's parameters are linear in its gradients
PAR_GP_STEPS = 5       # timed steps of the GP GCN after the checked one
PAR_CLI_RUNS = (("sync", ["--Model", "GraphSAGE"]),
                ("async", ["--Model", "GraphSAGE", "--async_dp"]),
                ("device sampling", ["--Model", "GraphSAGE", "--device_sampling"]))
# the keys of the JAX CLI's data-parallel trials (dgll_tpu/run.py:_run_dp_trial)
JAX_DP_KEYS = {"test_acc", "micro_f1", "metric_name", "metric", "best_val", "epochs",
               "train_s", "total_s", "n_devices", "async_dp", "resumed_from"}
JAX_DP_DEVICE_KEYS = JAX_DP_KEYS | {"device_sampling", "window_sampling", "exact_eval"}
K1_SHARD = ("spmm_csr (K1) on a rank's shard of A, [rows, n_node] (graph-partition "
            "GCN's sharded SpMM)")


def _dp_runner(csr, train_nodes, mesh, cuda_graph=None):
    """``(runner, state)``: the flagship's GraphSAGE (weights from the bench's seed,
    dropout 0) and Adam (capturable, fused) in a ``DeviceDPEpochRunner`` of
    ``PAR_BATCH`` seeds a rank, block-window draws, as the bench's."""
    from dgll_tpu_torch import bench
    from dgll_tpu_torch.nn import GraphSAGE
    from dgll_tpu_torch.train import GRAPH_ADAM, DeviceDPEpochRunner

    model = GraphSAGE(bench.SAGE_FEAT, bench.SAGE_HIDDEN, bench.SAGE_CLASSES, dropout=0.0,
                      generator=torch.Generator().manual_seed(bench.SEED))
    runner = DeviceDPEpochRunner(
        model, functools.partial(torch.optim.Adam, lr=1e-3, **GRAPH_ADAM), csr,
        bench.FANOUTS, PAR_BATCH, train_nodes, mesh, seed=bench.SEED, window=True,
        cuda_graph=cuda_graph)
    return runner, runner.init_state()


def _gp_apply(model, spmm, x, generator=None):
    """The graph-partition GCN: two layers, ReLU between, log-softmax."""
    h = torch.relu(spmm(x @ model["w1"]))
    return torch.log_softmax(spmm(h @ model["w2"]), dim=-1)


def _gp_model(weights, device="cuda"):
    """A fresh copy of ``weights`` (numpy) as parameters on ``device``."""
    return torch.nn.ParameterDict({k: torch.tensor(v) for k, v in weights.items()}
                                  ).to(device)


def _phase24_rank(work: str) -> int:
    """One rank of phase 24 (started by ``launch_local``): (a) one device-DP epoch of
    the flagship (its parameters saved for the check), one timed, then one timed with
    the all-reduces traced (their spans' CUDA events); (b) the GP GCN on this rank's
    shard: its log-probs and one SGD step (K1's launches counted from 0), then
    ``PAR_GP_STEPS`` timed steps."""
    from dgll_tpu_torch.ops.cuda import segment_matmul as sm
    from dgll_tpu_torch.parallel import gp, launch
    from dgll_tpu_torch.parallel import mesh as meshes
    from dgll_tpu_torch.parallel.partition import PartitionedGraph
    from dgll_tpu_torch.sampling import DeviceCSR
    from dgll_tpu_torch.train import create_train_state
    from dgll_tpu_torch.utils import profiling

    launch.initialize_distributed(device="cuda")
    mesh = meshes.make_mesh()
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"backend": mesh.backend, "device": str(dev)}
    d = torch.load(os.path.join(work, "flagship.pt"), weights_only=False)
    csr = DeviceCSR.from_host_arrays(d["indptr"], d["src"], dev)
    feats, labels = d["feats"].to(dev), d["labels"].to(dev)
    runner, state = _dp_runner(csr, d["train_nodes"], mesh)
    t0 = time.perf_counter()
    state, loss = runner.run_epoch(state, feats, labels)  # the draws: draw_epoch's
    out["first_epoch_s"] = time.perf_counter() - t0
    out["params"] = [p.detach().cpu() for p in state.model.parameters()]
    out["batch_losses"] = runner.batch_losses.cpu()
    t0 = time.perf_counter()
    state, loss = runner.run_epoch(state, feats, labels)
    float(loss)
    out["epoch_s"] = time.perf_counter() - t0
    profiling.reset()
    t0 = time.perf_counter()
    with profiling.tracing():  # the all-reduces' spans, for collective_ms
        _, loss = runner.run_epoch(state, feats, labels)
        float(loss)
    out["traced_epoch_s"] = time.perf_counter() - t0
    out["n_batches"] = runner.n_batches
    out["collective_ms"] = runner.collective_ms()
    del runner, state, csr, feats, labels, d
    torch.cuda.empty_cache()

    p = torch.load(os.path.join(work, "gp.pt"), weights_only=False)
    shard = gp.shard_partitioned_graph(PartitionedGraph(**p["pg"]), mesh, dev)
    model = _gp_model(p["weights"])
    gp_state = create_train_state(model, functools.partial(torch.optim.SGD, lr=PAR_GP_LR))
    step = gp.make_gp_gcn_train_step(mesh, shard, _gp_apply)
    spmm = gp.make_sharded_spmm(mesh, shard)
    sm.launches_fwd = sm.launches_bwd = 0
    with torch.no_grad():
        out["logits"] = _gp_apply(model, spmm, shard.node_feat).cpu()
    gp_state, loss = step(gp_state, shard.node_feat, shard.labels, shard.train_mask)
    out["gp_loss"] = float(loss)
    out["k1_launches"] = (sm.launches_fwd, sm.launches_bwd)
    out["gp_params"] = {k: v.detach().cpu() for k, v in model.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PAR_GP_STEPS):
        gp_state, loss = step(gp_state, shard.node_feat, shard.labels, shard.train_mask)
    float(loss)  # waits for the last step
    out["gp_step_s"] = (time.perf_counter() - t0) / PAR_GP_STEPS
    out["rows"] = shard.rows_per_shard
    torch.save(out, os.path.join(work, f"rank{mesh.rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def _dp_reference(data, ranks) -> None:
    """(a)'s check: one process runs both ranks' sub-batches of every batch, with the
    ranks' draws (their runners' generators, seeded alike), sums their gradients as
    the ranks' all-reduce does, and takes the step; its parameters against every
    rank's, within ``PAR_TOL`` x max|ref|."""
    from dgll_tpu_torch.parallel.mesh import Mesh
    from dgll_tpu_torch.train import masked_nll_loss

    runners = [_dp_runner(data.csr, data.train_nodes, Mesh(("data",), PAR_RANKS, r),
                          cuda_graph=False) for r in range(PAR_RANKS)]
    for runner, _ in runners:
        runner.load_epoch(runner.draw_epoch())
    runner0, state = runners[0]
    model = state.model
    for i in range(runner0.n_batches):
        state.optimizer.zero_grad(set_to_none=True)
        for runner, _ in runners:
            draws = [tuple(t[i] for t in u) if isinstance(u, tuple) else u[i]
                     for u in runner._draws]
            _, _, blocks = runner.sample_fn(runner.csr, runner._seeds[i], runner._mask[i],
                                            draws=draws)
            x = data.feats.index_select(0, blocks[0].src_ids)
            y = data.labels.index_select(0, blocks[-1].dst_ids)
            loss = masked_nll_loss(model(blocks, x), y, blocks[-1].dst_mask)
            loss.backward()  # accumulates: the ranks' gradients summed
        state.optimizer.step()
    want = [p.detach().cpu() for p in model.parameters()]
    for r, got in enumerate(ranks):
        for k, (g, w) in enumerate(zip(got["params"], want)):
            err = (g - w).abs().max().item()
            check(err <= PAR_TOL * w.abs().max().item(),
                  f"DP epoch rank {r}: parameter {k} within {PAR_TOL} x max|ref| of one "
                  f"process (err {err:.3e})")
    for k, (a, b) in enumerate(zip(ranks[0]["params"], ranks[1]["params"])):
        check(torch.equal(a, b), f"DP epoch: the ranks' parameter {k} bitwise equal")


def _gp_one_process(pg, weights, lr: float = PAR_GP_LR, device="cuda") -> dict:
    """The one-process K1 GCN on the whole (relabelled) graph of ``pg``: its log-probs,
    then one SGD step (its loss and the parameters after it)."""
    from dgll_tpu_torch.ops import build_chunked_pair
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_chunked
    from dgll_tpu_torch.train import masked_nll_loss

    # the shards' real edges (weight 0 is padding), back in one relabelled graph
    keep = pg.edge_weight != 0
    dst = pg.dst_local + (np.arange(pg.n_shard) * pg.rows_per_shard)[:, None]
    c, ct = build_chunked_pair(pg.src[keep], dst[keep], pg.n_node, pg.n_node,
                               pg.edge_weight[keep])
    c, ct = c.to(device), ct.to(device)
    n = pg.n_node

    def spmm(x):
        return spmm_chunked(c, ct, x)[:n]

    model = _gp_model(weights, device)
    x = torch.from_numpy(pg.node_feat).to(device)
    with torch.no_grad():
        logits = _gp_apply(model, spmm, x).cpu()
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    loss = masked_nll_loss(_gp_apply(model, spmm, x),
                           torch.from_numpy(pg.labels).to(device),
                           torch.from_numpy(pg.train_mask).to(device))
    loss.backward()
    opt.step()
    return {"logits": logits, "loss": loss.item(),
            "params": {k: v.detach().cpu() for k, v in model.items()}}


def _gp_against(ref: dict, ranks, tol: float, what: str, key: str = "") -> dict:
    """The ranks' log-probs (stacked) and their parameters after one SGD step
    (``<key>logits``, ``<key>gp_loss``, ``<key>gp_params``) against the one-process
    K1 GCN's, within ``tol`` x max|ref|."""
    want = ref["logits"]
    got = torch.cat([r[f"{key}logits"] for r in ranks])
    err = (got - want).abs().max().item()
    check(err <= tol * want.abs().max().item(),
          f"{what} log-probs within {tol} x max|ref| of one process (err {err:.3e})")
    step_err = 0.0
    for r in ranks:
        loss = r[f"{key}gp_loss"]
        check(abs(loss - ref["loss"]) <= 1e-5 * abs(ref["loss"]),
              f"{what} loss {loss} against one process's {ref['loss']}")
        for k, v in ref["params"].items():
            e = (r[f"{key}gp_params"][k] - v).abs().max().item()
            step_err = max(step_err, e)
            check(e <= tol * v.abs().max().item(),
                  f"{what} step: {k} within {tol} x max|ref| of one process ({e:.3e})")
    return {"logits_err": err, "step_err": step_err, "loss": ref["loss"]}


def _gp_reference(pg, weights, ranks) -> dict:
    """(b)'s check: the one-process K1 GCN on the whole (relabelled) graph; the ranks'
    log-probs (stacked) and their parameters after one SGD step against it."""
    return _gp_against(_gp_one_process(pg, weights), ranks, PAR_GP_TOL, "GP")


def _k1_shard_times(pg) -> dict:
    """K1 on rank 0's shard layout at width 128, beside its plain version and
    ``torch.sparse.mm`` on the same CSR, and its bound (``k1_reads``)."""
    from dgll_tpu_torch.ops import spmm_chunked_reference
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_csr_cuda
    from dgll_tpu_torch.parallel import gp
    from dgll_tpu_torch.parallel.mesh import Mesh

    lay = gp.shard_partitioned_graph(pg, Mesh(("data",), PAR_RANKS, 0), "cuda").chunked
    gen = torch.Generator(device="cuda").manual_seed(24)
    x = torch.randn(lay.n_cols, 128, generator=gen, device="cuda")
    got, want = spmm_csr_cuda(lay, x), spmm_chunked_reference(lay, x)
    err = (got - want).abs().max().item()
    check(err <= 1e-4 * want.abs().max().item(),
          f"K1 on the shard: within 1e-4 x max|ref| of its plain version ({err:.3e})")
    mat = csr(lay.indptr, lay.src, lay.weight, (lay.n_rows, lay.n_cols))
    t = timed(Case(lambda: spmm_csr_cuda(lay, x), lambda: spmm_chunked_reference(lay, x),
                   lambda: torch.sparse.mm(mat, x), k1_reads(lay, x),
                   2 * lay.src.numel() * 128), (got,))
    print(f"[24 K1 shard] [{lay.n_rows}, {lay.n_cols}] layout, {lay.src.numel()} edges, "
          f"F=128: {describe(t)}; max abs err {err:.3e}")
    return {**t, "err": err}


def _parallel_cli() -> dict:
    """(c): the CLI with ``--n_devices 2`` on the CLI's graph, one epoch each, the
    three runs at once (each starts its own ranks; the parent only waits): every
    run returns (its ranks exit 0) with the JAX CLI's keys."""
    from concurrent.futures import ThreadPoolExecutor

    from dgll_tpu_torch import run

    def one(extra):
        t0 = time.perf_counter()
        res = run.main([*MINIBATCH_ARGS, *extra, "--n_devices", str(PAR_RANKS),
                        "--n_epochs", "1"], timeout=300)
        return res, time.perf_counter() - t0

    with contextlib.redirect_stdout(io.StringIO()), ThreadPoolExecutor(3) as ex:
        done = list(ex.map(one, [extra for _, extra in PAR_CLI_RUNS]))
    out = {}
    for (name, extra), (res, wall) in zip(PAR_CLI_RUNS, done):
        trial = res["trials"][0]
        keys = JAX_DP_DEVICE_KEYS if "--device_sampling" in extra else JAX_DP_KEYS
        check(set(trial) == keys | {"epoch_loss", "epoch_s"},
              f"--n_devices 2 {name}: the JAX CLI's keys, got {sorted(trial)}")
        check(trial["n_devices"] == PAR_RANKS and trial["async_dp"] == ("--async_dp" in extra)
              and all(np.isfinite(trial["epoch_loss"])) and 0 <= trial["test_acc"] <= 1,
              f"--n_devices 2 {name}: finite losses, the flags reported")
        print(f"[24 cli] --n_devices 2 {name}: loss {trial['epoch_loss']}, test_acc "
              f"{trial['test_acc']:.4f}, epoch s {[round(v, 3) for v in trial['epoch_s']]}, "
              f"wall {wall:.1f} s (the three at once)")
        out[name] = {"test_acc": trial["test_acc"], "epoch_loss": trial["epoch_loss"],
                     "epoch_s": trial["epoch_s"], "wall_s": wall}
    return out


def phase_parallel(data, flagship: dict) -> dict:
    """Phase 24: two ranks sharing the card over gloo (``launch_local``). (a) The
    device-DP epoch of the flagship at full width (phase 20's data, GraphSAGE 256,
    fanouts [15, 10], 512 seeds a rank) against one process; (b) the graph-partition
    GCN (the slices' graph, 2 layers at 128, K1 on each shard) against the one-process
    K1 GCN; K1 on a shard timed; (c) the CLI with ``--n_devices 2``."""
    from dgll_tpu_torch.parallel import launch_local, partition_graph
    from dgll_tpu_torch.run import build_dataset
    from dgll_tpu_torch.tools.profile_slice import SLICE_ARGS
    from dgll_tpu_torch.utils import parse_train_config

    t0 = time.perf_counter()
    os.makedirs(PAR_DIR, exist_ok=True)
    torch.save({"indptr": data.indptr, "src": data.src, "feats": data.feats.cpu(),
                "labels": data.labels.cpu(), "train_nodes": data.train_nodes},
               os.path.join(PAR_DIR, "flagship.pt"))
    pg = partition_graph(build_dataset(parse_train_config(SLICE_ARGS)), PAR_RANKS)
    rng = np.random.default_rng(24)
    n_class = int(pg.labels.max()) + 1
    weights = {"w1": rng.normal(0, 0.1, (pg.node_feat.shape[1], 128)).astype(np.float32),
               "w2": rng.normal(0, 0.1, (128, n_class)).astype(np.float32)}
    torch.save({"pg": vars(pg), "weights": weights}, os.path.join(PAR_DIR, "gp.pt"))
    t_files = time.perf_counter() - t0
    launch_local(PAR_RANKS, [sys.executable, os.path.abspath(__file__), "--phase24-rank",
                             PAR_DIR], timeout=600)
    ranks = [torch.load(os.path.join(PAR_DIR, f"rank{r}.pt"), weights_only=False)
             for r in range(PAR_RANKS)]
    t_ranks = time.perf_counter() - t0 - t_files
    _dp_reference(data, ranks)
    nb = ranks[0]["n_batches"]
    batch_ms = [1e3 * r["epoch_s"] / nb for r in ranks]
    traced_ms = [1e3 * r["traced_epoch_s"] / nb for r in ranks]
    share = [r["collective_ms"] / (1e3 * r["traced_epoch_s"]) for r in ranks]
    single = flagship["bench"]["value"]
    print(f"[24 dp] {PAR_RANKS} ranks ({ranks[0]['backend']}, {ranks[0]['device']}), "
          f"{nb} batches of {PAR_RANKS} x {PAR_BATCH}: parameters within {PAR_TOL} x "
          f"max|ref| of one process, the ranks' bitwise equal; ms a global batch "
          f"{[round(v, 4) for v in batch_ms]} (one process, phase 20: {single:.4f}), "
          f"traced {[round(v, 4) for v in traced_ms]}; the all-reduce's share of the "
          f"traced epoch (its span's CUDA events, the wait for the other rank's step on "
          f"the shared card included) {[round(v, 4) for v in share]} "
          f"({[round(r['collective_ms'] / nb, 4) for r in ranks]} ms a batch); first "
          f"epoch (capture) {[round(r['first_epoch_s'], 2) for r in ranks]} s")
    for r, got in enumerate(ranks):
        check(got["k1_launches"] == (4, 2),
              f"GP rank {r}: K1 launched 4 times forward and twice backward (log-probs "
              f"and one step), got {got['k1_launches']}")
    gp_check = _gp_reference(pg, weights, ranks)
    print(f"[24 gp] {PAR_RANKS} shards of {ranks[0]['rows']} rows ({pg.n_node} nodes, "
          f"{int((pg.edge_weight != 0).sum())} edges), 2 layers at 128: log-probs within "
          f"{gp_check['logits_err']:.3e}, one SGD step within {gp_check['step_err']:.3e} of "
          f"the one-process K1 GCN; K1 launches a rank {ranks[0]['k1_launches']}; ms a step "
          f"{[round(1e3 * r['gp_step_s'], 3) for r in ranks]}")
    k1 = _k1_shard_times(pg)
    cli = _parallel_cli()
    out = {"dp_batch_ms": batch_ms, "dp_traced_batch_ms": traced_ms,
           "dp_allreduce_share": share, "single_batch_ms": single,
           "gp_step_ms": [1e3 * r["gp_step_s"] for r in ranks], "gp_check": gp_check,
           "k1_launches": ranks[0]["k1_launches"], "k1_shard": k1, "cli": cli,
           "files_s": t_files, "ranks_s": t_ranks}
    print(f"[24 done] phase 24 in {time.perf_counter() - t0:.1f} s (files {t_files:.1f} s, "
          f"ranks {t_ranks:.1f} s)")
    return out


PAR25_DIR = os.path.join("build", "phase25")
HALO_TOL = 1e-5        # phase 25's paths against one process, x max|ref|
HALO_STEPS = 5         # timed steps of each graph-partition path after the checked one
HALO_FEAT = 128        # the GCN's width, and the exchange's row width
TP_HIDDEN = 128        # the TP GCN's hidden width: 64 a rank
# DeepWalk's published settings (Perozzi et al., KDD 2014: dimension 128, walk length
# 40, window 10), 5 negatives and batches of 8,192 pairs, on a 20,000-node graph of
# average degree 16; 4 walks a node, the paper's 80 cut so that the epoch (2.05 ms a
# step on the card) keeps phase 25 near 90 s (PERF.md section 4)
DEEPWALK = dict(n_node=20_000, avg_degree=16, dim=128, walk_length=40, window=10,
                n_negative=5, batch=8192, num_walks=4, lr=1e-2)
# Adam divides a gradient by its root mean square plus eps 1e-8, and at a batch of
# 8,192 pairs (the loss a mean) many table gradients are within a few eps: the float32
# rounding of such a gradient (sums in another order on the card and on the CPU) moves
# its update by a visible share of the learning rate in either (the CPU test's
# reason at tests/test_torch_embedding.py:W_IN_TOL). So after 3 steps each table on
# the card is held against the same steps in float64 on the CPU: no further from them
# than SKIPGRAM_F64_FACTOR times the CPU's float32 tables are, plus 1e-5 x max|ref|.
# The loss is held to 1e-5 of the CPU's, relative.
SKIPGRAM_F64_FACTOR = 3.0
K2_SHARD = ("spmm_windowed (K2) on a rank's captured local edges, [rows, rows] (the "
            "windowed halo SpMM of graph-partition GCN)")
K1_HALO = ("spmm_csr (K1) on a rank's halo layout, [rows, rows + D*H] (the halo SpMM "
           "of graph-partition GCN)")
K1_TP = ("spmm_csr (K1) on a rank's feature slice, [n_node, F/D] (tensor-parallel "
         "GCN)")
K1_SAGE = ("spmm_csr (K1) on a full graph's mean layout, 1 / deg on each edge (full-batch "
           "GraphSAGE's mean, forward and backward)")
K1_GCN = ("spmm_csr (K1) on a full graph's GCN layout, dinv[dst] * dinv[src] on each "
          "edge (full-batch GCNII's propagation, forward and backward)")
HALO_REPLACES = "dgll_tpu/parallel/halo.py:284"


COLLECTIVE_NAMES = ("gloo", "nccl", "c10d", "record_param_comms", "all_to_all",
                    "alltoall", "allgather", "all_gather", "allreduce", "all_reduce")


def _union_ms(spans) -> float:
    """The time covered by the ``(start, end)`` spans (microseconds), in ms."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            total, end = total + b - max(a, end), b
    return total / 1e3


def _traced_step(mesh, run, log_dir: str) -> dict:
    """One more step of every rank, rank 0's inside ``device_trace``: from its trace,
    the device's busy time (the union of kernels, copies and sets) split into K1, K2,
    copies and the rest, and the host time in which a collective was under way (the
    union of the host events named by ``COLLECTIVE_NAMES``, on any thread), beside the
    step's time on the host clock. Empty on the other ranks."""
    from dgll_tpu_torch.parallel import mesh as meshes
    from dgll_tpu_torch.utils import device_trace

    meshes.barrier(mesh)
    torch.cuda.synchronize()
    if mesh.rank != 0:
        run()
        return {}
    with device_trace(log_dir):
        t0 = time.perf_counter()
        run()
        wall = 1e3 * (time.perf_counter() - t0)
    (name,) = [f for f in os.listdir(log_dir) if f.endswith(".json")]
    with open(os.path.join(log_dir, name)) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    os.remove(os.path.join(log_dir, name))
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    sums = collections.Counter()
    for e in dev:
        n = e["name"]
        sums["K1" if "spmm_csr_kernel" in n else "K2" if "spmm_windowed_kernel" in n
             else "copies" if e["cat"] != "kernel" else "other"] += e["dur"] / 1e3
    comm = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")
            and any(k in e["name"].lower() for k in COLLECTIVE_NAMES)]
    out = {"wall_ms": wall, "device_ms": _union_ms((e["ts"], e["ts"] + e["dur"]) for e in dev),
           **{f"{k}_ms": sums[k] for k in ("K1", "K2", "copies", "other")},
           "collective_ms": _union_ms((e["ts"], e["ts"] + e["dur"]) for e in comm),
           "collective_names": sorted({e["name"] for e in comm})}
    check(out["K1_ms"] > 0, f"the traced step's device events name K1: {dict(sums)}")
    return out


def _halo_paths(mesh, pg, weights, device, steps: int = HALO_STEPS) -> dict:
    """(a) on this rank: the 2-layer GCN through the halo exchange (forced), the
    windowed halo SpMM and the all-gather (gp.py's), each from the same weights: its
    log-probs and one SGD step, every launch counter set to 0 just before and read
    just after, then ``steps`` timed steps and one traced (``_traced_step``)."""
    from dgll_tpu_torch.parallel import gp, halo
    from dgll_tpu_torch.parallel import mesh as meshes
    from dgll_tpu_torch.train import create_train_state

    shard = gp.shard_partitioned_graph(pg, mesh, device)
    plan = halo.build_halo_plan(pg)
    t0 = time.perf_counter()
    sw = halo.build_shard_windowed(pg, mesh.rank)
    out = {"windowed_build_s": time.perf_counter() - t0, "halo_size": plan.halo_size,
           "windowed_fraction": sw.windowed_fraction,
           "captured": 0 if sw.win is None else sw.win.src.numel(),
           "t_residual": sw.win_t is not None and sw.win_t.res is not None,
           "t_windowed": sw.win_t is not None and sw.win_t.win.src.numel() > 0,
           "halo_bytes": halo.halo_volume_bytes(pg, plan, HALO_FEAT),
           "allgather_bytes": halo.allgather_volume_bytes(pg, HALO_FEAT)}
    auto, out["auto"] = halo.make_partitioned_spmm(mesh, pg, HALO_FEAT, "auto", device)
    paths = {"halo": auto if out["auto"] == "halo" else
             halo.make_partitioned_spmm(mesh, pg, HALO_FEAT, "halo", device)[0],
             "windowed": halo.make_halo_spmm_windowed(mesh, shard, plan, sw),
             "allgather": gp.make_sharded_spmm(mesh, shard)}
    for name, spmm in paths.items():
        model = _gp_model(weights, device)
        state = create_train_state(model, functools.partial(torch.optim.SGD, lr=PAR_GP_LR))
        step = gp.make_gp_gcn_train_step(mesh, shard, _gp_apply, spmm)
        meshes.barrier(mesh)
        _zero_all_counters()
        with torch.no_grad():
            out[f"{name}:logits"] = _gp_apply(model, spmm, shard.node_feat).cpu()
        state, loss = step(state, shard.node_feat, shard.labels, shard.train_mask)
        out[f"{name}:gp_loss"] = float(loss)
        out[f"{name}:launches"] = {k: v for k, v in _all_counters().items() if v}
        out[f"{name}:gp_params"] = {k: v.detach().cpu().clone() for k, v in model.items()}
        meshes.barrier(mesh)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, loss = step(state, shard.node_feat, shard.labels, shard.train_mask)
        float(loss)  # waits for the last step
        out[f"{name}:step_ms"] = 1e3 * (time.perf_counter() - t0) / max(steps, 1)

        def one_step():
            nonlocal state
            state, loss = step(state, shard.node_feat, shard.labels, shard.train_mask)
            float(loss)

        out[f"{name}:trace"] = _traced_step(mesh, one_step,
                                            os.path.join(PAR25_DIR, f"trace_{name}"))
    return out


def _tp_rank(mesh, t, device) -> dict:
    """(d) on this rank: the TP GCN's log-probs and the gradients of its masked NLL
    in this rank's slices, K1's launches counted, then its forward and backward
    timed."""
    from dgll_tpu_torch.nn import tp_params_from_numpy
    from dgll_tpu_torch.parallel import tp
    from dgll_tpu_torch.parallel import mesh as meshes
    from dgll_tpu_torch.train import masked_nll_loss

    tp_mesh = meshes.make_mesh(("model",))
    apply = tp.make_tp_gcn_apply(tp_mesh, t["src"], t["dst"], t["w"], t["n"],
                                 device=device)
    params = {k: v.to(device).requires_grad_(True)
              for k, v in tp_params_from_numpy(t["weights"], tp_mesh).items()}
    x, labels, mask = (torch.from_numpy(t[k]).to(device) for k in ("x", "labels", "mask"))

    def fwd_bwd():
        for v in params.values():
            v.grad = None
        loss = masked_nll_loss(apply(params, x), labels, mask)
        loss.backward()
        return loss

    meshes.barrier(mesh)
    _zero_all_counters()
    with torch.no_grad():
        logp = apply(params, x)
    loss = fwd_bwd()
    out = {"tp_launches": {k: v for k, v in _all_counters().items() if v},
           "tp_logp": logp.cpu(), "tp_loss": loss.item(),
           "tp_grads": {k: v.grad.cpu().clone() for k, v in params.items()}}
    meshes.barrier(mesh)
    t0 = time.perf_counter()
    for _ in range(HALO_STEPS):
        loss = fwd_bwd()
    float(loss)
    out["tp_step_ms"] = 1e3 * (time.perf_counter() - t0) / HALO_STEPS
    return out


def _phase25_rank(work: str) -> int:
    """One rank of phase 25 (started by ``launch_local``): (a) the graph-partition GCN
    on the clustered graph through the three exchanges, (d) the TP GCN on the slices'
    graph."""
    from dgll_tpu_torch.parallel import launch
    from dgll_tpu_torch.parallel import mesh as meshes
    from dgll_tpu_torch.parallel.partition import PartitionedGraph

    launch.initialize_distributed(device="cuda")
    mesh = meshes.make_mesh()
    dev = torch.device("cuda", torch.cuda.current_device())
    p = torch.load(os.path.join(work, "gp.pt"), weights_only=False)
    out = {"backend": mesh.backend, "device": str(dev),
           **_halo_paths(mesh, PartitionedGraph(**p["pg"]), p["weights"], dev)}
    del p
    torch.cuda.empty_cache()
    out.update(_tp_rank(mesh, torch.load(os.path.join(work, "tp.pt"), weights_only=False),
                        dev))
    torch.save(out, os.path.join(work, f"rank{mesh.rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def _expected_gp_launches(rank: dict, name: str) -> dict:
    """The launches of the log-probs and one step of a 2-layer GCN: K1 twice a forward
    and once a layer backward on the exchange's layout; on the windowed path K2 also,
    its backward on the transpose's cut (K2 where it captures, K1 on its residual)."""
    want = {"K1 fwd": 4, "K1 bwd": 2}
    if name == "windowed" and rank["captured"]:
        want["K2 fwd"] = 4
        if rank["t_windowed"]:
            want["K2 bwd"] = 2
        if rank["t_residual"]:
            want["K1 bwd"] += 2
    return want


def _k2_shard_times(win) -> dict:
    """(b): K2 on rank 0's captured local edges at width 128 against its plain
    version (1e-5 x max|ref|, bitwise repeatable), timed beside ``sparse.mm`` of the
    same edges, with its bound by bytes."""
    from dgll_tpu_torch.ops.cuda.spmm_windowed import spmm_windowed_cuda
    from dgll_tpu_torch.ops.windowed import spmm_windowed_reference

    gen = torch.Generator(device="cuda").manual_seed(25)
    x = torch.randn(win.n_cols, HALO_FEAT, generator=gen, device="cuda")
    got, again = spmm_windowed_cuda(win, x), spmm_windowed_cuda(win, x)
    want = spmm_windowed_reference(win, x)
    err = (got - want).abs().max().item()
    check(err <= 1e-5 * want.abs().max().item() and torch.equal(got, again),
          f"K2 on the shard: within 1e-5 x max|ref| of its plain version ({err:.3e}), "
          f"bitwise repeatable")
    mat = torch.sparse_coo_tensor(torch.stack([win.rows.long(), win.src.long()]),
                                  win.weight, (win.n_rows, win.n_cols)).coalesce()
    mat = mat.to_sparse_csr()
    t = timed(Case(lambda: spmm_windowed_cuda(win, x), lambda: spmm_windowed_reference(win, x),
                   lambda: torch.sparse.mm(mat, x),
                   (win.blk_ptr, win.sub_ptr, win.sub_x0, win.sub_nx, win.src, win.rows,
                    win.weight, x), 2 * win.src.numel() * HALO_FEAT), (got,))
    print(f"[25 K2 shard] [{win.n_rows}, {win.n_cols}] layout, {win.src.numel()} edges in "
          f"{win.n_sub} sub-chunks staging {int(win.sub_nx.sum())} rows, F={HALO_FEAT}: "
          f"{describe(t)}; max abs err {err:.3e}")
    return {**t, "err": err}


def _k1_layout_times(lay, f: int, tag: str, seed: int, phase: int = 25) -> dict:
    """K1 on ``lay`` at width ``f`` against its plain version (1e-5 x max|ref|),
    timed beside ``sparse.mm`` on the same CSR, with its bound (``k1_reads``)."""
    from dgll_tpu_torch.ops import spmm_chunked_reference
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_csr_cuda

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(lay.n_cols, f, generator=gen, device="cuda")
    got, want = spmm_csr_cuda(lay, x), spmm_chunked_reference(lay, x)
    err = (got - want).abs().max().item()
    check(err <= 1e-5 * want.abs().max().item(),
          f"K1 on the {tag}: within 1e-5 x max|ref| of its plain version ({err:.3e})")
    mat = csr(lay.indptr, lay.src, lay.weight, (lay.n_rows, lay.n_cols))
    t = timed(Case(lambda: spmm_csr_cuda(lay, x), lambda: spmm_chunked_reference(lay, x),
                   lambda: torch.sparse.mm(mat, x), k1_reads(lay, x),
                   2 * lay.src.numel() * f), (got,))
    print(f"[{phase} K1 {tag}] [{lay.n_rows}, {lay.n_cols}] layout, {lay.src.numel()} edges, "
          f"F={f}: {describe(t)}; max abs err {err:.3e}")
    return {**t, "err": err}


SAGE_N, SAGE_PAIRS = 169_343, 1_166_243  # ogbn-arxiv's published sizes
SAGE_WIDTHS = (128, 512)  # a two-layer GraphSAGE's aggregations: features, hidden 512


def sage_graph(seed: int = 27):
    """An ogbn-arxiv-sized graph on the card: ``SAGE_PAIRS`` pairs, destinations by
    ``(v + 1) ** -0.9``, sources uniform, stored both ways, and a self-loop a node."""
    from dgll_tpu_torch.graph import Graph

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cdf = torch.cumsum((torch.arange(SAGE_N, dtype=torch.float64, device="cuda") + 1)
                       ** -0.9, 0)
    u = torch.rand(SAGE_PAIRS, generator=gen, device="cuda", dtype=torch.float64)
    dst = torch.searchsorted(cdf / cdf[-1], u).clamp_max_(SAGE_N - 1)
    src = torch.randint(0, SAGE_N, (SAGE_PAIRS,), generator=gen, device="cuda")
    src = torch.where(src == dst, (src + 1) % SAGE_N, src)
    loops = torch.arange(SAGE_N, device="cuda")
    src, dst = torch.cat([src, dst, loops]), torch.cat([dst, src, loops])
    return Graph.from_edges(src.cpu().numpy(), dst.cpu().numpy(), SAGE_N).to("cuda")


def phase_sage_k1() -> dict:
    """Phase 26: full-batch GraphSAGE's mean on K1. ``Graph.mean_chunked`` built on
    the card (timed at its first use, and again by CUDA events on a copy); the
    wrapper as ``SAGEConv`` calls it (``spmm_chunked(a, at, x)``, forward and autograd
    backward on A^T) at each of ``SAGE_WIDTHS`` against the plain version through
    autograd, 1e-5 x max|ref| for out and dx, its launches counted (one forward and
    one backward a width, nothing else); then K1 alone on A and A^T at each width
    (``_k1_layout_times``) and the COO mean it replaced. Returns {"A 128": times, ...,
    "launches", "err", "build_s", "build_ms", "coo_ms"}."""
    from dgll_tpu_torch.ops import spmm_chunked_reference
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_chunked
    from dgll_tpu_torch.ops.spmm import spmm_mean_coo
    from dgll_tpu_torch.utils.profiling import cuda_median_ms

    g = sage_graph()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a, at = g.mean_chunked
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0, "build_ms": cuda_median_ms(
        lambda: g.replace().mean_chunked, 2, 7)}
    print(f"[26 sage] {g.n_node} nodes, {g.n_edge} edges; A: {_split_summary(a)}; "
          f"A^T: {_split_summary(at)}; mean_chunked at first use {out['build_s']:.3f} s, "
          f"then {out['build_ms']:.3f} ms")
    gen = torch.Generator(device="cuda").manual_seed(27)
    err = 0.0
    _zero_counters()
    for f in SAGE_WIDTHS:
        x = torch.randn(g.n_node, f, generator=gen, device="cuda", requires_grad=True)
        cot = torch.randn(a.n_rows, f, generator=gen, device="cuda")
        (spmm_chunked(a, at, x) * cot).sum().backward()
        got = spmm_chunked(a, at, x.detach())
        xr = x.detach().clone().requires_grad_(True)
        ref = spmm_chunked_reference(a, xr)
        (ref * cot).sum().backward()
        for name, have, want in (("out", got, ref.detach()), ("dx", x.grad, xr.grad)):
            e = (have - want).abs().max().item()
            tol = 1e-5 * want.abs().max().item()
            print(f"[26 sage] F={f} {name} {tuple(have.shape)}: max abs err {e:.3e}, "
                  f"tolerance {tol:.3e}")
            check(e <= tol, f"SAGE's mean on K1 within 1e-5 x max|ref| (F={f}, {name})")
            err = max(err, e)
        del ref, xr, got
    torch.cuda.synchronize()
    counts = {k: v for k, v in _counters().items() if v}
    want = {"K1 fwd": 2 * len(SAGE_WIDTHS), "K1 bwd": len(SAGE_WIDTHS)}
    check(counts == want, f"SAGE's mean launched K1 {want} and nothing else: {counts}")
    out.update(launches=counts, err=err, coo_ms={})
    for f in SAGE_WIDTHS:
        for name, lay in (("A", a), ("A^T", at)):
            out[f"{name} {f}"] = _k1_layout_times(lay, f, f"sage {name}", 28, phase=26)
        x = torch.randn(g.n_node, f, generator=gen, device="cuda")
        out["coo_ms"][f] = cuda_median_ms(
            lambda: spmm_mean_coo(g.src, g.dst, x, g.n_node), 1, 5)
        print(f"[26 sage] F={f}: the COO mean it replaced (spmm_mean_coo) "
              f"{out['coo_ms'][f]:.4f} ms")
    return out


GCN_WIDTH = 64  # GCNII's hidden width (gnnbench/configs/gcnii64-64.json)


def phase_gcn_k1() -> dict:
    """Phase 27: full-batch GCNII's propagation on K1. ``Graph.gcn_chunked`` built on
    the card (timed at its first use, and again by CUDA events on a copy); the
    wrapper as ``GCN2Conv`` calls it (``spmm_chunked(a, at, x)``, forward and autograd
    backward on A^T) at ``GCN_WIDTH`` against the plain version through autograd,
    1e-5 x max|ref| for out and dx, its launches counted (two forward, one backward,
    nothing else); then K1 alone on A and A^T (``_k1_layout_times``). Returns {"A":
    times, "A^T": times, "launches", "err", "build_s", "build_ms"}."""
    from dgll_tpu_torch.ops import spmm_chunked_reference
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_chunked
    from dgll_tpu_torch.utils.profiling import cuda_median_ms

    g = sage_graph()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a, at = g.gcn_chunked
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0, "build_ms": cuda_median_ms(
        lambda: g.replace().gcn_chunked, 2, 7)}
    print(f"[27 gcn] {g.n_node} nodes, {g.n_edge} edges; A: {_split_summary(a)}; "
          f"A^T: {_split_summary(at)}; gcn_chunked at first use {out['build_s']:.3f} s, "
          f"then {out['build_ms']:.3f} ms")
    gen = torch.Generator(device="cuda").manual_seed(29)
    f = GCN_WIDTH
    err = 0.0
    _zero_counters()
    x = torch.randn(g.n_node, f, generator=gen, device="cuda", requires_grad=True)
    cot = torch.randn(a.n_rows, f, generator=gen, device="cuda")
    (spmm_chunked(a, at, x) * cot).sum().backward()
    got = spmm_chunked(a, at, x.detach())
    torch.cuda.synchronize()
    counts = {k: v for k, v in _counters().items() if v}
    xr = x.detach().clone().requires_grad_(True)
    ref = spmm_chunked_reference(a, xr)
    (ref * cot).sum().backward()
    for name, have, want in (("out", got, ref.detach()), ("dx", x.grad, xr.grad)):
        e = (have - want).abs().max().item()
        tol = 1e-5 * want.abs().max().item()
        print(f"[27 gcn] F={f} {name} {tuple(have.shape)}: max abs err {e:.3e}, "
              f"tolerance {tol:.3e}")
        check(e <= tol, f"GCNII's propagation on K1 within 1e-5 x max|ref| ({name})")
        err = max(err, e)
    del ref, xr, got
    want = {"K1 fwd": 2, "K1 bwd": 1}
    check(counts == want, f"GCNII's propagation launched K1 {want} and nothing else: "
                          f"{counts}")
    out.update(launches=counts, err=err)
    for name, lay in (("A", a), ("A^T", at)):
        out[name] = _k1_layout_times(lay, f, f"gcn {name}", 30, phase=27)
    return out


GCNII_SOURCE = "dgll_tpu_torch/csrc/gcnii_fused.cu"
GCNII_FWD = ("gcnii_fused_fwd (GCNII's layer after P x: initial residual, identity mapping, "
             "ReLU and the next dropout in one pass)")
GCNII_BWD = ("gcnii_fused_bwd (its backward: g_agg, g_h0 and dW through per-block partials "
             "summed in block order)")
GCNII_RATE = 0.6                 # the benchmark configuration's dropout
GCNII_BETAS = (0.4054651081081644, 0.0077821404420549489)  # layers 1 and 64 (lamda 0.5)
GCNII_TILED = (128, 256)         # widths of the tiled kernels checked and timed


def _gcnii_composition(agg, h0, w, u, alpha, beta, keep):
    """The composition the fused layer replaces, as GCNII ran it: ``GCN2Conv``'s
    ``lerp`` and ``addmm`` after the padded row's slice, the ReLU, and ``_dropout``'s
    select on the mask ``u < keep``."""
    n = h0.shape[0]
    s = torch.lerp(agg[:n], h0, alpha)
    z = torch.addmm(s, s, w, beta=1.0 - beta, alpha=beta)
    return torch.where(u < keep, torch.relu(z) / keep, 0.0), z


def _gcnii_checks(n: int, f: int, gen, beta: float) -> dict:
    """The forward and backward kernels at ``[n, f]`` against the composition through
    autograd, the padded row space one row longer: values within 1e-5 x max|ref|; the
    masks equal to ``_dropout``'s on the same generator state; the flags equal to the
    composition's ``~(z <= 0) & kept`` except where ``|z|`` is within 1e-6 x max|z| of
    0 (the sign of a rounding; the cotangent is 0 there, so that both backwards see one
    ReLU); everything bitwise repeatable."""
    from dgll_tpu_torch.nn.models import _dropout
    from dgll_tpu_torch.ops.cuda import gcnii_fused as gf

    alpha, keep = 0.1, 1.0 - GCNII_RATE
    agg = torch.randn(n + 1, f, generator=gen, device="cuda")
    h0 = torch.relu(torch.randn(n, f, generator=gen, device="cuda"))
    w = (torch.rand(f, f, generator=gen, device="cuda") * 2 - 1) / math.sqrt(f)
    state = gen.get_state()
    u = torch.rand(n, f, generator=gen, device="cuda")
    gen.set_state(state)
    mask = _dropout(torch.ones(n, f, device="cuda"), GCNII_RATE, gen) != 0
    check(torch.equal(mask, u < keep), "the kernel's uniforms draw _dropout's mask")
    args = (agg, h0, w, u, alpha, beta, keep)
    out, s, flags = gf.gcnii_fused_fwd_cuda(*args)
    again = gf.gcnii_fused_fwd_cuda(*args)
    check(all(torch.equal(a, b) for a, b in zip((out, s, flags), again)),
          "the forward kernel is bitwise repeatable")
    leaves = [t.clone().requires_grad_(True) for t in (agg, h0, w)]
    want, z = _gcnii_composition(leaves[0], leaves[1], leaves[2], u, alpha, beta, keep)
    z = z.detach()
    edge = z.abs() <= 1e-6 * z.abs().max()
    ref_flags = ~(z <= 0) & mask
    off = flags != ref_flags
    check(not bool((off & ~edge).any()), "the flags equal (z > 0) & kept off the edge")
    check(torch.equal(flags & mask, flags), "no flag where the mask drops")
    errs, out_exact = {}, int((out == want.detach()).sum())
    for name, have, ref in (("out", out, want.detach()),
                            ("s", s, torch.lerp(agg[:n], h0, alpha))):
        errs[name] = (have - ref).abs().max().item()
        check(errs[name] <= 1e-5 * ref.abs().max().item(),
              f"GCNII's fused forward within 1e-5 x max|ref| ({name}, beta {beta:.4f})")
    g = torch.randn(n, f, generator=gen, device="cuda").masked_fill_(off | edge, 0.0)
    want.backward(g)
    got = gf.gcnii_fused_bwd_cuda(g, flags, s, w, n + 1, alpha, beta, keep)
    again = gf.gcnii_fused_bwd_cuda(g, flags, s, w, n + 1, alpha, beta, keep)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "the backward kernel is bitwise repeatable (dW through its partials)")
    check(not bool(got[0][n:].any()), "the padded row's gradient is 0")
    for name, have, leaf in zip(("g_agg", "g_h0", "dW"), got, leaves):
        errs[name] = (have - leaf.grad).abs().max().item()
        check(errs[name] <= 1e-5 * leaf.grad.abs().max().item(),
              f"GCNII's fused backward within 1e-5 x max|ref| ({name}, beta {beta:.4f})")
    print(f"[28 gcnii] [{n}, {f}] beta {beta:.4f}: max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; out bitwise equal to the composition at {out_exact} of {n * f}; flags off "
          f"the composition's at {int(off.sum())}, {int(edge.sum())} values within 1e-6 x "
          f"max|z| of 0; masks, repeats: equal")
    return {"err": max(errs.values()), "out_exact": out_exact, "flags_off": int(off.sum())}


def _gcnii_times(n: int, f: int, gen) -> dict:
    """Each kernel alone at ``[n, f]`` beside the plain formulas on the card and the
    composition it replaces (forward; backward through autograd, the padded row's slice
    included): ``timed``'s plain and library columns, and its bound."""
    from dgll_tpu_torch.ops.cuda import gcnii_fused as gf

    alpha, beta, keep = 0.1, GCNII_BETAS[0], 1.0 - GCNII_RATE
    agg = torch.randn(n + 1, f, generator=gen, device="cuda")
    h0 = torch.relu(torch.randn(n, f, generator=gen, device="cuda"))
    w = (torch.rand(f, f, generator=gen, device="cuda") * 2 - 1) / math.sqrt(f)
    u = torch.rand(n, f, generator=gen, device="cuda")
    g = torch.randn(n, f, generator=gen, device="cuda")
    args = (agg, h0, w, u, alpha, beta, keep)
    out, s, flags = gf.gcnii_fused_fwd_cuda(*args)
    fwd = timed(Case(lambda: gf.gcnii_fused_fwd_cuda(*args),
                     lambda: gf.gcnii_layer_reference(*args),
                     lambda: _gcnii_composition(*args), (agg[:n], h0, w, u),
                     2 * n * f * f), (out, s, flags))
    leaves = [t.clone().requires_grad_(True) for t in (agg, h0, w)]

    def composition_bwd():
        want, _ = _gcnii_composition(*leaves, u, alpha, beta, keep)
        want.backward(g)

    bargs = (g, flags, s, w, n + 1, alpha, beta, keep)
    got = gf.gcnii_fused_bwd_cuda(*bargs)
    bwd = timed(Case(lambda: gf.gcnii_fused_bwd_cuda(*bargs),
                     lambda: gf.gcnii_layer_backward_reference(*bargs),
                     composition_bwd, (g, flags, s, w), 4 * n * f * f), got)
    for name, t in (("forward", fwd), ("backward", bwd)):
        print(f"[28 gcnii {name}] [{n}, {f}]: {describe(t)} (library: the composition "
              f"it replaces{', its forward and autograd backward' if name == 'backward' else ''})")
    return {"fwd": fwd, "bwd": bwd}


def _gcnii_composed(model, g, x, gen):
    """GCNII's forward as the composition of PyTorch operations the fused layer
    replaces, on the model's weights: ``_dropout`` before each layer and the head,
    K1's sum, ``lerp``, ``addmm`` and ``relu``."""
    from dgll_tpu_torch.nn.models import _dropout
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_chunked

    h0 = torch.relu(model.fcs[0](_dropout(x, model.dropout, gen)))
    h = h0
    for conv in model.convs:
        agg = spmm_chunked(*g.gcn_chunked, _dropout(h, model.dropout, gen))[: g.n_node]
        s = torch.lerp(agg, h0, conv.alpha)
        h = torch.relu(torch.addmm(s, s, conv.weight, beta=1.0 - conv.beta, alpha=conv.beta))
    return torch.log_softmax(model.fcs[1](_dropout(h, model.dropout, gen)), dim=-1)


def _gcnii_step(g, fused: bool, layers: int, gen_seed: int = 31) -> dict:
    """One training step of GCNII (``layers`` x 64, dropout 0.6) on ``g``, through the
    model (``fused``) or the composition written out: its loss, the launches of K1 and
    of the fused kernels, the traced counters, and the step's ms over 5 steps after 2."""
    from dgll_tpu_torch.nn import GCNII
    from dgll_tpu_torch.ops.cuda import gcnii_fused as gf
    from dgll_tpu_torch.ops.cuda import segment_matmul as sm
    from dgll_tpu_torch.utils import profiling

    x = torch.randn(g.n_node, 128, generator=torch.Generator(device="cuda").manual_seed(7),
                    device="cuda")
    model = GCNII(128, GCN_WIDTH, 40, n_layers=layers, dropout=GCNII_RATE, device="cuda",
                  generator=torch.Generator().manual_seed(5))
    def step():
        model.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(gen_seed)
        logp = model(g, x, generator=gen) if fused else _gcnii_composed(model, g, x, gen)
        loss = logp[:, 0].mean()
        loss.backward()
        return loss

    _zero_counters()
    gf.launches_fwd = gf.launches_bwd = 0
    profiling.reset()
    with profiling.tracing():
        loss = step()
    torch.cuda.synchronize()
    counts = {"K1 fwd": sm.launches_fwd, "K1 bwd": sm.launches_bwd,
              "fused fwd": gf.launches_fwd, "fused bwd": gf.launches_bwd,
              **profiling.report()["counters"]}
    profiling.reset()
    grads = [p.grad.detach().clone() for p in model.parameters()]
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    return {"loss": float(loss.detach()), "counts": counts, "ms": ms, "grads": grads}


def phase_gcnii_fused() -> dict:
    """Phase 28: GCNII's fused layer (``ops/cuda/gcnii_fused.py``). Both kernels at
    ``[169343, 64]`` against the composition they replace (``_gcnii_checks``, at the
    first and the last layer's beta), each timed alone (``_gcnii_times``), and so the
    tiled kernels at the widths ``GCNII_TILED``; then one training step of the 64-layer
    model on the ogbn-arxiv-sized graph through the model and through the composition
    written out, from one state and one generator seed: loss and each leaf's gradient
    norm within 1e-5 relative, 64 launches of each kernel and 64 + 64 of K1,
    ``conv.identity_map_fused`` 64 (none on the composition), and each step's ms.
    Returns {"err", "fwd", "bwd", "tiled", "launches", "step_ms", ...}."""
    gen = torch.Generator(device="cuda").manual_seed(28)
    n = SAGE_N
    checks = [_gcnii_checks(n, GCN_WIDTH, gen, beta) for beta in GCNII_BETAS]
    out = {"err": max(c["err"] for c in checks), "checks": checks,
           **_gcnii_times(n, GCN_WIDTH, gen), "tiled": {}}
    for f in GCNII_TILED:
        check_f = _gcnii_checks(n, f, gen, GCNII_BETAS[0])
        out["tiled"][f] = {"err": check_f["err"], **_gcnii_times(n, f, gen)}
    g = sage_graph()
    layers = 64
    fused = _gcnii_step(g, True, layers)
    plain = _gcnii_step(g, False, layers)
    want = {"K1 fwd": layers, "K1 bwd": layers, "fused fwd": layers, "fused bwd": layers,
            "conv.aggregate_gcn": layers, "conv.identity_map_fused": layers}
    check(fused["counts"] == want, f"a fused step launched {want}: {fused['counts']}")
    check(plain["counts"].get("fused fwd") == 0 and "conv.identity_map_fused"
          not in plain["counts"], f"the composition launched no fused kernel: "
          f"{plain['counts']}")
    loss_gap = abs(fused["loss"] - plain["loss"]) / abs(plain["loss"])
    # each leaf's gap of gradient norms, the benchmark's grad_gap: a ReLU whose input
    # rounds to the other sign on one side moves single entries, not the norms
    grad_gap = max(abs(a.norm().item() - b.norm().item()) / b.norm().item()
                   for a, b in zip(fused["grads"], plain["grads"]))
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(fused["grads"], plain["grads"]))
    print(f"[28 gcnii step] {layers} x {GCN_WIDTH}, dropout {GCNII_RATE}: fused "
          f"{fused['ms']:.3f} ms, composition {plain['ms']:.3f} ms a step "
          f"({plain['ms'] / fused['ms']:.2f}x); loss gap {loss_gap:.3e}, worst leaf's "
          f"gap of gradient norms {grad_gap:.3e} (of entries {worst:.3e} x its max); "
          f"launches {fused['counts']}")
    check(loss_gap <= 1e-5, "the fused step's loss within 1e-5 of the composition's")
    check(grad_gap <= 1e-5, "the fused step's gradient norms within 1e-5 of the "
                            "composition's")
    out.update(launches=fused["counts"], step_ms={"fused": fused["ms"],
                                                  "composition": plain["ms"]},
               loss_gap=loss_gap, grad_gap=grad_gap)
    return out


def _tp_reference(t, ranks, device="cuda") -> dict:
    """(d)'s check: the one-process K1 GCN with the whole weights; every rank's
    log-probs and its slices' gradients against it, within ``HALO_TOL`` x max|ref|."""
    from dgll_tpu_torch.ops import build_chunked_pair
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_chunked
    from dgll_tpu_torch.train import masked_nll_loss

    n = t["n"]
    c, ct = build_chunked_pair(t["src"], t["dst"], n, n, t["w"])
    c, ct = c.to(device), ct.to(device)
    params = {k: torch.from_numpy(v).to(device).requires_grad_(True)
              for k, v in t["weights"].items()}
    x = torch.from_numpy(t["x"]).to(device)
    h = spmm_chunked(c, ct, x @ params["w1"], activation="relu")[:n]
    logp = torch.log_softmax(spmm_chunked(c, ct, h)[:n] @ params["w2"] + params["b2"], -1)
    loss = masked_nll_loss(logp, torch.from_numpy(t["labels"]).to(device),
                           torch.from_numpy(t["mask"]).to(device))
    loss.backward()
    want = logp.detach().cpu()
    errs = {"logp": 0.0, "grads": 0.0}
    k = TP_HIDDEN // PAR_RANKS
    for r, got in enumerate(ranks):
        e = (got["tp_logp"] - want).abs().max().item()
        errs["logp"] = max(errs["logp"], e)
        check(e <= HALO_TOL * want.abs().max().item(),
              f"TP rank {r}: log-probs within {HALO_TOL} x max|ref| of one process ({e:.3e})")
        check(abs(got["tp_loss"] - loss.item()) <= 1e-5 * abs(loss.item()),
              f"TP rank {r}: loss {got['tp_loss']} against one process's {loss.item()}")
        cut = {"w1": (slice(None), slice(r * k, (r + 1) * k)),
               "w2": (slice(r * k, (r + 1) * k),), "b2": (slice(None),)}
        for name, idx in cut.items():
            g = params[name].grad.cpu()[idx]
            e = (got["tp_grads"][name] - g).abs().max().item()
            errs["grads"] = max(errs["grads"], e)
            check(e <= HALO_TOL * g.abs().max().item(),
                  f"TP rank {r}: d{name} within {HALO_TOL} x max|ref| ({e:.3e})")
    lay = c
    del ct, params, h, logp
    return {**errs, "loss": loss.item(), "layout": lay}


def _deepwalk(device="cuda", cfg=None, cpu_check: bool = True) -> dict:
    """(f): DeepWalk at its published settings on the card: walks and pairs on the
    host (timed), 3 skip-gram steps on the card against the same steps on the CPU
    with the same negatives (the loss to 1e-5; the tables against the steps in
    float64, ``SKIPGRAM_F64_FACTOR``), then one epoch timed; the embeddings'
    softmax-regression accuracy (the card's machine has no sklearn) above chance."""
    from dgll_tpu_torch.data import synthetic_classification_graph
    from dgll_tpu_torch.embedding import (SkipGramModel, WalkGraph, deepwalk_walks,
                                          train_classifier, walk_pairs)

    cfg = {**DEEPWALK, **(cfg or {})}
    g = synthetic_classification_graph(n_node=cfg["n_node"], avg_degree=cfg["avg_degree"],
                                       n_class=8, feat_dim=8, homophily=0.9, seed=0)
    t0 = time.perf_counter()
    wg = WalkGraph.from_graph(g)
    walks = deepwalk_walks(wg, cfg["num_walks"], cfg["walk_length"], seed=0)
    walk_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pairs = walk_pairs(walks, cfg["window"], np.random.default_rng(0))
    pairs_s = time.perf_counter() - t0
    n, b, k = wg.n_node, cfg["batch"], cfg["n_negative"]
    model = SkipGramModel(n, cfg["dim"], k, cfg["lr"], seed=0, device=device)
    out = {"walks": int(walks.shape[0]), "walks_per_s": walks.shape[0] / walk_s,
           "walk_s": walk_s, "pairs": len(pairs), "pairs_s": pairs_s}
    if cpu_check:
        tables = {key: v.cpu() for key, v in model.state_dict().items()}
        plain = SkipGramModel(n, cfg["dim"], k, cfg["lr"], seed=0, device="cpu")
        plain.load_state_dict(tables)
        exact = SkipGramModel(n, cfg["dim"], k, cfg["lr"], seed=0, device="cpu").double()
        exact.load_state_dict({key: v.double() for key, v in tables.items()})
        exact.optimizer = torch.optim.Adam(exact.parameters(), lr=cfg["lr"])
        gen = torch.Generator().manual_seed(25)
        for i in range(3):
            batch = pairs[i * b:(i + 1) * b]
            neg = torch.randint(0, n, (len(batch), k), generator=gen)
            got = model.step(batch[:, 0], batch[:, 1], neg.to(device))
            want = plain.step(batch[:, 0], batch[:, 1], neg)
            exact.step(batch[:, 0], batch[:, 1], neg)
            check(abs(got.item() - want.item()) <= 1e-5 * abs(want.item()),
                  f"skip-gram step {i}: loss {got.item()} against the CPU's {want.item()}")
        for name in ("w_in", "w_out"):
            ref = getattr(exact, name).detach()
            card = getattr(model, name).detach().cpu().double()
            cpu = getattr(plain, name).detach().double()
            e_card, e_cpu = ((t - ref).abs().max().item() for t in (card, cpu))
            out[f"{name}_err"] = (card - cpu).abs().max().item()
            out[f"{name}_f64_err"] = {"card": e_card, "cpu": e_cpu}
            check(e_card <= SKIPGRAM_F64_FACTOR * e_cpu + HALO_TOL * ref.abs().max().item(),
                  f"skip-gram {name} after 3 steps: the card {e_card:.3e} from the float64 "
                  f"steps, the CPU's float32 {e_cpu:.3e}")
    steps = 20
    batch = torch.from_numpy(pairs[:b]).to(device)
    model.step(batch[:, 0], batch[:, 1])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = model.step(batch[:, 0], batch[:, 1])
    float(loss)
    out["step_ms"] = 1e3 * (time.perf_counter() - t0) / steps
    t0 = time.perf_counter()
    out["epoch_loss"] = model.train(pairs, epochs=1, batch_size=b, seed=0)
    out["epoch_s"] = time.perf_counter() - t0
    out["epoch_steps"] = len(pairs) // min(b, len(pairs))
    labels = g.labels[:n].numpy()
    out["accuracy"], _ = train_classifier(model.embeddings, labels, "logistic", seed=0)
    check(np.isfinite(out["epoch_loss"]) and np.isfinite(model.embeddings).all(),
          "DeepWalk: a finite loss and finite embeddings")
    check(out["accuracy"] > 1.5 / 8, f"DeepWalk: accuracy {out['accuracy']} above chance")
    return out


def phase_halo_tp() -> dict:
    """Phase 25: two ranks share the card over gloo (``launch_local``). (a) The
    graph-partition GCN on the clustered graph (200,000 nodes, 2 range shards, 2
    layers at 128) through the halo exchange, the windowed halo SpMM (K2 on each
    shard's captured edges) and the all-gather, each against the one-process K1 GCN;
    (b) K2 on rank 0's shard and (c) K1 on its halo layout, checked and timed; (d)
    the TP GCN on the slices' graph (hidden 128, 64 a rank) against one process, K1
    on a [200000, 64] slice timed; (e) ``dryrun_multichip(2)``; (f) DeepWalk."""
    from dgll_tpu_torch.bench import clustered_graph
    from dgll_tpu_torch.data import gcn_normalize
    from dgll_tpu_torch.entry import dryrun_multichip
    from dgll_tpu_torch.parallel import halo, launch_local, partition_graph
    from dgll_tpu_torch.run import build_dataset
    from dgll_tpu_torch.tools.profile_slice import SLICE_ARGS
    from dgll_tpu_torch.utils import parse_train_config

    t0 = time.perf_counter()
    os.makedirs(PAR25_DIR, exist_ok=True)
    pg = partition_graph(gcn_normalize(clustered_graph(200_000, 16)), PAR_RANKS,
                         strategy="range")
    rng = np.random.default_rng(25)
    n_class = int(pg.labels.max()) + 1
    weights = {"w1": rng.normal(0, 0.1, (HALO_FEAT, HALO_FEAT)).astype(np.float32),
               "w2": rng.normal(0, 0.1, (HALO_FEAT, n_class)).astype(np.float32)}
    torch.save({"pg": vars(pg), "weights": weights}, os.path.join(PAR25_DIR, "gp.pt"))
    g = build_dataset(parse_train_config(SLICE_ARGS))
    e, n = g.n_real_edge, g.n_real_node
    f_in, c_out = g.node_feat.shape[1], int(g.labels.max()) + 1
    t = {"src": g.src[:e].numpy(), "dst": g.dst[:e].numpy(), "w": g.edge_weight[:e].numpy(),
         "n": n, "x": g.node_feat[:n].numpy(), "labels": g.labels[:n].numpy(),
         "mask": g.train_mask[:n].numpy(),
         "weights": {"w1": rng.normal(0, np.sqrt(2.0 / f_in), (f_in, TP_HIDDEN)
                                      ).astype(np.float32),
                     "w2": rng.normal(0, np.sqrt(2.0 / TP_HIDDEN), (TP_HIDDEN, c_out)
                                      ).astype(np.float32),
                     "b2": np.zeros(c_out, np.float32)}}
    torch.save(t, os.path.join(PAR25_DIR, "tp.pt"))
    del g
    t_files = time.perf_counter() - t0
    launch_local(PAR_RANKS, [sys.executable, os.path.abspath(__file__), "--phase25-rank",
                             PAR25_DIR], timeout=600)
    ranks = [torch.load(os.path.join(PAR25_DIR, f"rank{r}.pt"), weights_only=False)
             for r in range(PAR_RANKS)]
    t_ranks = time.perf_counter() - t0 - t_files

    # (a) every path against the one-process K1 GCN, its launches a step
    ref = _gp_one_process(pg, weights)
    out = {"paths": {}}
    for name in ("halo", "windowed", "allgather"):
        chk = _gp_against(ref, ranks, HALO_TOL, f"GP {name}", key=f"{name}:")
        for r, got in enumerate(ranks):
            want = _expected_gp_launches(got, name)
            check(got[f"{name}:launches"] == want,
                  f"GP {name} rank {r}: launches {got[f'{name}:launches']}, want {want}")
        out["paths"][name] = {**chk, "launches": [r[f"{name}:launches"] for r in ranks],
                              "step_ms": [r[f"{name}:step_ms"] for r in ranks]}
        print(f"[25 gp] {name}: log-probs within {chk['logits_err']:.3e}, one SGD step "
              f"within {chk['step_err']:.3e} of the one-process K1 GCN; launches (log-probs "
              f"and one step) a rank {out['paths'][name]['launches']}; ms a step "
              f"{[round(v, 3) for v in out['paths'][name]['step_ms']]}")
    r0 = ranks[0]
    for name in ("halo", "windowed", "allgather"):
        tr = out["paths"][name]["trace"] = r0[f"{name}:trace"]
        print(f"[25 trace] {name}, rank 0, one step: {tr['wall_ms']:.4f} ms on the host "
              f"clock; device busy {tr['device_ms']:.4f} ms ({tr['device_ms'] / tr['wall_ms']:.1%}"
              f"; K1 {tr['K1_ms']:.4f}, K2 {tr['K2_ms']:.4f}, copies {tr['copies_ms']:.4f}, "
              f"other {tr['other_ms']:.4f}); a collective under way for "
              f"{tr['collective_ms']:.4f} ms ({tr['collective_ms'] / tr['wall_ms']:.1%}; "
              f"{tr['collective_names']})")
    for k in ("halo_size", "halo_bytes", "allgather_bytes", "auto", "windowed_fraction"):
        check(all(r[k] == r0[k] for r in ranks), f"the ranks agree on {k}")
        out[k] = r0[k]
    check(r0["auto"] == ("halo" if r0["halo_bytes"] < r0["allgather_bytes"] else "allgather"),
          "the automatic choice takes the exchange of fewer bytes")
    print(f"[25 plan] {pg.n_shard} range shards of {pg.rows_per_shard} rows "
          f"({int((pg.edge_weight != 0).sum())} edges): H {r0['halo_size']}, all-to-all "
          f"{r0['halo_bytes']} B against all-gather {r0['allgather_bytes']} B a step at "
          f"F={HALO_FEAT}, auto {r0['auto']}; windowed_fraction {r0['windowed_fraction']:.4f}"
          f", captured edges a rank {[r['captured'] for r in ranks]}, the shard's windowed "
          f"build {[round(r['windowed_build_s'], 2) for r in ranks]} s")

    # (b), (c): the new layouts of K2 and K1, rank 0's
    plan = halo.build_halo_plan(pg)
    win = halo.build_shard_windowed(pg, 0).win.to("cuda")
    out["k2_shard"] = _k2_shard_times(win)
    lay, _ = halo.halo_layout(pg, plan, 0)
    out["k1_halo"] = _k1_layout_times(lay.to("cuda"), HALO_FEAT, "halo layout", 26)
    del win, lay

    # (d) the TP GCN against one process, K1 on one rank's feature slice
    tp_check = _tp_reference(t, ranks)
    for r, got in enumerate(ranks):
        check(got["tp_launches"] == {"K1 fwd": 4, "K1 bwd": 2},
              f"TP rank {r}: K1 launched 4 times forward, twice backward, got "
              f"{got['tp_launches']}")
    out["k1_tp"] = _k1_layout_times(tp_check.pop("layout"), TP_HIDDEN // PAR_RANKS,
                                    "TP slice", 27)
    out["tp"] = {**tp_check, "launches": r0["tp_launches"],
                 "step_ms": [r["tp_step_ms"] for r in ranks]}
    print(f"[25 tp] {PAR_RANKS} ranks, hidden {TP_HIDDEN} ({TP_HIDDEN // PAR_RANKS} a "
          f"rank), {t['n']} nodes, {len(t['src'])} edges: log-probs within "
          f"{tp_check['logp']:.3e}, gradients within {tp_check['grads']:.3e} of one "
          f"process; K1 launches a rank {r0['tp_launches']}; ms a forward and backward "
          f"{[round(v, 3) for v in out['tp']['step_ms']]}")
    del t

    # (e) the dry run on the card; (f) DeepWalk
    t_dry = time.perf_counter()
    line = dryrun_multichip(PAR_RANKS)
    check(line.endswith(" OK") and "nan" not in line, "dryrun_multichip(2) ends in OK")
    out["dryrun"] = {"line": line, "s": time.perf_counter() - t_dry}
    print(f"[25 dryrun] {line} ({out['dryrun']['s']:.1f} s)")
    out["deepwalk"] = _deepwalk()
    dw = out["deepwalk"]
    print(f"[25 deepwalk] {DEEPWALK['n_node']} nodes, {dw['walks']} walks of "
          f"{DEEPWALK['walk_length']}: {dw['walks_per_s']:.0f} walks a second (host), "
          f"{dw['pairs']} pairs in {dw['pairs_s']:.2f} s; 3 steps against the CPU: w_in "
          f"{dw['w_in_err']:.3e}, w_out {dw['w_out_err']:.3e} (from float64: "
          f"{dw['w_in_f64_err']}, {dw['w_out_f64_err']}); {dw['step_ms']:.4f} ms a "
          f"step, an epoch ({dw['epoch_steps']} steps) {dw['epoch_s']:.2f} s, loss "
          f"{dw['epoch_loss']:.4f}; logistic accuracy {dw['accuracy']:.4f}")
    out.update(files_s=t_files, ranks_s=t_ranks)
    print(f"[25 done] phase 25 in {time.perf_counter() - t0:.1f} s (files {t_files:.1f} s, "
          f"ranks {t_ranks:.1f} s)")
    return out


def kernel_row(name, source, replaces, launches, err, t) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_env()
    phase_build()
    worst = phase_check()
    times = phase_time()
    sl = phase_slice()
    gat_errs = {}  # max abs error per kernel, test graph and slice's shapes
    phase_gat_check(gat_errs)
    phase_gat_layer()
    gat_times = phase_gat_time(gat_errs)
    gat_counts, gat_f32 = phase_gat_slice()
    win_err = phase_windowed_check()
    hyb = phase_hybrid()
    bench = phase_bench()
    r4_errs = {}  # max abs error per round-4 kernel, test graph and slice's shapes
    phase_r4_check(r4_errs)
    r4_counts = phase_r4_layers()
    r4 = phase_r4_time(r4_errs)
    k8_err = phase_quantize_check()
    k8_times = phase_quantize_time()
    minibatch = phase_minibatch_cli()
    cache = phase_cache()
    probe_kernels = phase_probe_kernels()
    probe_res, probe_counts = phase_probe_tool()
    from dgll_tpu_torch import bench as flagship_bench

    t_data = time.perf_counter()
    data = flagship_bench.flagship_data("cuda")  # phases 20 and 21
    print(f"[20 data] the bench's graph, features and labels in "
          f"{time.perf_counter() - t_data:.1f} s")
    flagship = phase_flagship(data)
    host_packed = phase_host_packed(data)
    layerwise = phase_layerwise(data, smi)
    bf16 = phase_bf16(gat_f32)
    parallel = phase_parallel(data, flagship)
    del data
    halo_tp = phase_halo_tp()
    sage = phase_sage_k1()
    gcn = phase_gcn_k1()
    gcnii = phase_gcnii_fused()
    t = times[(128, "A")]
    kernels = [kernel_row("spmm_csr (K1: weighted SpMM, fused bias + ReLU)", KERNEL_SOURCE,
                          REPLACES, sl["launches"], max(worst, t["err"]), t)]
    for name, key, replaces in (*GAT_KERNELS, (K1_GAT, K1_GAT, REPLACES)):
        kernels.append(kernel_row(name, KERNEL_SOURCE if key == K1_GAT else GAT_SOURCE,
                                  replaces, gat_counts[key], gat_errs[key], gat_times[key]))
    k2, k2_times = bench["auto"]["launches"], hyb["times"]["A"]
    kernels.append(kernel_row(
        "spmm_windowed (K2: windowed SpMM, fused bias + ReLU)", WINDOWED_SOURCE,
        WINDOWED_REPLACES, k2["k2_fwd"] + k2["k2_bwd"], max(win_err, hyb["err"]),
        {"ms": k2_times["K2"], "plain_ms": k2_times["K2 plain"],
         "library_ms": k2_times["K2 library"], "bound_ms": k2_times["K2 bound"],
         "bound_by": k2_times["K2 bound_by"]}))
    for name, key, replaces in R4_KERNELS:
        kernels.append(kernel_row(name, GAT_SOURCE, replaces, r4_counts[key], r4_errs[key],
                                  r4["kernels"][key]))
    print(f"[12 bench] step_ms windowed {bench['auto']['step_ms']:.4f}, "
          f"K1 alone {bench['chunked']['step_ms']:.4f}")
    kernels.append(kernel_row(
        "quantize_int8_fill (K8: the int8 cache's whole fill in one call: column maxima, "
        "scales, the quantize pass)", QUANTIZE_SOURCE, QUANTIZE_REPLACES,
        cache["budget_6.25pct_int8"]["k8_launches"], k8_err, k8_times["whole fill"]))
    bk, bf16_counts = bf16["kernels"], bf16["cli"]["launches"]
    kernels.append(kernel_row(K7_BF16, GAT_SOURCE, GAT_KERNELS[-1][2],
                              bf16_counts["expand_rows"], bk["k7_err"], bk["k7"]))
    kernels.append(kernel_row(K1_BF16, KERNEL_SOURCE, REPLACES,
                              bf16_counts["K1 fwd"] + bf16_counts["K1 bwd"], bk["k1_err"],
                              bk["k1"]))
    kernels.append(kernel_row(K1_SHARD, KERNEL_SOURCE, REPLACES,
                              sum(parallel["k1_launches"]), parallel["k1_shard"]["err"],
                              parallel["k1_shard"]))
    paths = halo_tp["paths"]
    kernels.append(kernel_row(
        K2_SHARD, WINDOWED_SOURCE, HALO_REPLACES,
        sum(paths["windowed"]["launches"][0].get(k, 0) for k in ("K2 fwd", "K2 bwd")),
        halo_tp["k2_shard"]["err"], halo_tp["k2_shard"]))
    kernels.append(kernel_row(
        K1_HALO, KERNEL_SOURCE, REPLACES,
        sum(paths["halo"]["launches"][0].get(k, 0) for k in ("K1 fwd", "K1 bwd")),
        halo_tp["k1_halo"]["err"], halo_tp["k1_halo"]))
    kernels.append(kernel_row(
        K1_TP, KERNEL_SOURCE, REPLACES,
        sum(halo_tp["tp"]["launches"].get(k, 0) for k in ("K1 fwd", "K1 bwd")),
        halo_tp["k1_tp"]["err"], halo_tp["k1_tp"]))
    kernels.append(kernel_row(K1_SAGE, KERNEL_SOURCE, REPLACES,
                              sage["launches"]["K1 fwd"] + sage["launches"]["K1 bwd"],
                              max(sage["err"], *(sage[f"A {f}"]["err"] for f in SAGE_WIDTHS)),
                              sage["A 128"]))
    kernels.append(kernel_row(K1_GCN, KERNEL_SOURCE, REPLACES,
                              gcn["launches"]["K1 fwd"] + gcn["launches"]["K1 bwd"],
                              max(gcn["err"], gcn["A"]["err"], gcn["A^T"]["err"]), gcn["A"]))
    for name, key in ((GCNII_FWD, "fwd"), (GCNII_BWD, "bwd")):
        kernels.append(kernel_row(name, GCNII_SOURCE, "none (the JAX package has no GCNII)",
                                  gcnii["launches"][f"fused {key}"], gcnii["err"],
                                  gcnii[key]))
    for name, key, line in PROBE_KERNELS:
        kernels.append(kernel_row(name, PROBES_SOURCE, f"{PROBE_SCRIPT}:{line}",
                                  probe_counts[key], probe_kernels[key]["err"],
                                  probe_kernels[key]["times"]))
    print(f"[15 layers] {json.dumps(r4['layers'])}")
    print(f"[17 cli] {json.dumps(minibatch)}")
    print(f"[18 cache] {json.dumps(cache)}")
    print(f"[19 probes] {json.dumps(probe_res)}")
    print(f"[20 flagship] {json.dumps(flagship)}")
    print(f"[21 host_packed] {json.dumps(host_packed)}")
    print(f"[22 layerwise] {json.dumps(layerwise)}")
    print(f"[23 bf16] {json.dumps({k: v for k, v in bf16.items() if k != 'kernels'})}")
    print(f"[24 parallel] {json.dumps(parallel)}")
    print(f"[25 halo_tp] {json.dumps(halo_tp)}")
    print(f"[26 sage] {json.dumps(sage)}")
    print(f"[27 gcn] {json.dumps(gcn)}")
    print(f"[28 gcnii] {json.dumps({k: v for k, v in gcnii.items() if k not in ('fwd', 'bwd')})}")
    print(f"[done] chip_smoke.py in {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase24-rank"]:
        sys.exit(_phase24_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--phase25-rank"]:
        sys.exit(_phase25_rank(sys.argv[2]))
    sys.exit(main())
