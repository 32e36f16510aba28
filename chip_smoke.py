#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in the checkout and drives the
port's six slices: two through the port's CLI (``dgll_tpu_torch.run.main``) on a
200k-node power-law graph, the third through the full-graph bench
(``dgll_tpu_torch.bench``) on a 200k-node clustered graph, the fourth through the
round-4 attention ops (``dgll_tpu_torch.ops``) on the power-law graph, the fifth
through the CLI's host minibatch path and the library's feature cache, the sixth
through the primitive probe (``dgll_tpu_torch.tools.probe``):

* full-batch GCN (phases 3-5): the SpMM kernel K1 against its plain PyTorch version
  on a power-law test graph and, through the autograd wrapper, at the slice's
  shapes; both timed there; 20 epochs of training, in which the CLI tries the
  windowed layout and declines it;
* full-batch GAT, 8 heads x 8 features (phases 6-9): the attention kernels K3-K7
  and K1 with runtime columns against their plain versions on the test graph; the
  fused layer's forward and backward against the plain composition at the slice's
  shapes; each kernel and its plain version timed there; 20 epochs of training;
* full-batch GCN on the clustered graph (phases 10-12): the windowed kernel K2
  against its plain version on a clustered test graph and one with an empty row
  block; the hybrid op (K2 plus K1 on the residual edges) forward and backward at
  the bench's shapes; K2, the hybrid op and K1 over the whole graph timed there; the
  bench's 14 train steps through K2, and again through K1 alone;
* the round-4 GAT attention layers (phases 13-15): K6 in its max mode, K9, and K6′
  and K10 (served by K7's and K6's kernels through counted wrappers) against their
  plain versions on the test graph; ``gat_attention_chunked_multihead`` (8 heads x
  8 features) and ``gat_attention_chunked`` (one head, F=16 and F=64) forward and
  backward against the fused op at the slice's shapes, with every launch counted;
  each kernel and both layers timed;
* the host minibatch path (phases 16-18): the int8 quantizer K8 against its plain
  version, exactly, in both rounding modes, without noise, with supplied noise and
  with its in-kernel Philox noise, at the int8 cache's shape, and timed there; the
  CLI's minibatch GraphSAGE (with the feature cache on 25% of the rows) and GCN
  runs, 3 epochs each, with each batch's time split into sampling, copies, feature
  fetch and the device step, and the device's idle share over an epoch; the feature
  cache's scenario (``benchmarks/cache_bench.py``): a device-resident run, float32
  caches on 0, 25 and 100% of the rows, and float32 against int8 at one byte budget,
  with the int8 fill's K8 launch counted;
* the primitive probes P0-P4 (phase 19): each probe's kernel against its plain
  version on ragged shapes and at the probe script's full sizes (E 2^22 rows of 128
  floats; P0, P2, P4 exact, P2b within rtol 1e-5, P3 within rtol 1e-4 and 1e-5 x
  max|ref|), each timed beside its plain version, ``copy_``, ``index_select`` or
  ``index_add_``, and its bound; P3 again with every row sent to 64 or 1,024
  destination rows (contended atomics, integer values: exact); then the probe
  tool's run at those sizes, whose JSON (with ``index_select`` as P1 and P0's
  achieved bandwidth) it prints.

Each slice's launch counters are set to 0 just before its run and read just after.
Each kernel is timed beside its plain version, one PyTorch library call computing
the same function where there is one (``library_ms``; the port never calls it), and
its bound: the larger of its bytes (each input read once, each output written once)
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
    ("rows_to_edges_multi (K6': K7's kernel at width H)", "rows_to_edges_multi",
     f"{EDGE_OPS}:249"),
    ("rows_to_edges (K10 rows to edges: K7's kernel at width 1)", "rows_to_edges",
     f"{EDGE_OPS}:39"),
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
    ("p2b_onehot (P2b: one-hot product on the tensor cores, TF32 hi + lo)", "p2b_onehot",
     102),
    ("p3_dynacc (P3: scatter-add through L2 atomics, zeroing included)", "p3_dynacc", 126),
    ("p4_dma (P4: row gather by bulk copies, 8 in flight a block)", "p4_dma", 171),
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


def csr(indptr, cols, values, shape):
    """A layout's edges as a torch sparse CSR matrix, the input of a library call."""
    return torch.sparse_csr_tensor(indptr, cols, values, size=shape,
                                   check_invariants=False)


def timed(case: Case, outs) -> dict:
    """A case's kernel, plain and library times (CUDA events, median of 15 after 3
    warm-ups) and bound, for the outputs ``outs`` of its kernel."""
    from dgll_tpu_torch.utils.profiling import cuda_median_ms

    b_ms, b_by = bound(nbytes(*case.reads, *outs), case.ops)
    return {"ms": cuda_median_ms(case.kernel), "plain_ms": cuda_median_ms(case.plain),
            "library_ms": None if case.library is None else cuda_median_ms(case.library),
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


def phase_check(n=50_000, e=800_000, device="cuda") -> float:
    c, ct, n = power_law_layouts(n, e, device)
    gen = torch.Generator(device=device).manual_seed(0)
    worst = 0.0
    for f in (16, 128, 256):
        for dtype in (torch.float32, torch.bfloat16):
            for act in (None, "relu"):
                errs, same = _kernel_case(c, ct, n, f, dtype, act, gen)
                ratio = max(v for k, v in errs.items() if not k.endswith("_abs"))
                print(f"[3 check] F={f} {str(dtype)[6:]} act={act}: "
                      f"max abs err out {errs['out_abs']:.3e} dx {errs['dx_abs']:.3e}"
                      + (f" db {errs['db_abs']:.3e}" if "db_abs" in errs else "")
                      + f"; {ratio:.3f} of tolerance; bitwise repeatable {same}")
                check(ratio <= 1.0, f"kernel within tolerance (F={f}, {dtype}, {act})")
                check(same, f"two runs bitwise equal (F={f}, {dtype}, {act})")
                if dtype == torch.float32:
                    worst = max(worst, errs["out_abs"], errs["dx_abs"])
    print(f"[3 check] {c.src.numel()} edges over {n} rows, max in-degree "
          f"{int((c.indptr[1:] - c.indptr[:-1]).max())}: all 12 cases pass")
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
            deg = int((lay.indptr[1:] - lay.indptr[:-1]).max())
            print(f"[4 time] F={f} {name}: {describe(t)}; {gbs:.1f} GB/s of gathered "
                  f"rows + indices, {nnz} edges, max in-degree {deg}")
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
    for K1; K7 only moves bytes."""
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
            lambda: torch.sparse.mm(a_mat, msg), (c.indptr, ids, w, msg),
            2 * nnz * width),
        "K1 t_slot_perm columns, unit weights, on A^T": Case(
            lambda: (spmm_csr_cuda(ct, msg, cols=perm, weights=ones),),
            lambda: (spmm_chunked_reference(ct, msg, cols=perm, weights=ones),),
            lambda: torch.sparse.mm(t_mat, msg), (ct.indptr, perm, ones, msg),
            2 * nnz * width),
    }


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
    version's, or equal to it with ``exact``; none of the kernels uses atomics, so
    two runs must be bitwise equal), keep its max abs error in ``worst`` under the
    kernel's JSON key, and return the printed summary and the kernel's outputs."""
    got, again, want = case.kernel(), case.kernel(), case.plain()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    errs = [_max_err(a, b, scale) for a, b in zip(got, want)]
    if exact:
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{name} equals its plain version ({tag})")
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
    graph, H in {1, 8}."""
    c, ct, n = power_law_layouts(n, e)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for heads, width in ((1, 16), (8, 64)):
        for name, case in _gat_cases(c, ct, heads, width, gen).items():
            line, _ = _compare(f"H={heads}", name, case, worst)
            print(f"[6 check] H={heads} width={width} {name}: {line}")
    print(f"[6 check] {c.src.numel()} edges over {n} rows, max in-degree "
          f"{int((c.indptr[1:] - c.indptr[:-1]).max())}: all cases pass")


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
    return counts


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


def phase_windowed_check() -> float:
    """Phase 10: K2 against ``spmm_windowed_reference`` on the clustered test graph
    (A: F in {16, 128, 256}, f32 and bf16, with and without bias + ReLU; A^T at
    F=128) and on one with an empty row block, whose rows must come out as
    act(bias) exactly. Returns the max abs error of the f32 cases."""
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
            lambda: (gf.expand_rows_cuda(c, s),),
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
    1e-4 of max|ref|, and every kernel bitwise repeatable."""
    c, ct, n = power_law_layouts(n, e)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for heads, width in ((1, 16), (8, 64)):
        for name, (case, scale) in _r4_cases(c, heads, width, gen).items():
            line, _ = _compare(f"H={heads}", name, case, worst, scale, scale == 0)
            print(f"[13 check] H={heads} F={width} {name}: {line}")
    print(f"[13 check] {c.src.numel()} edges over {n} rows, max in-degree "
          f"{int((c.indptr[1:] - c.indptr[:-1]).max())}: all cases pass")


def _counters() -> dict:
    """Every launch counter of the attention paths: ``edge_ops.launches``,
    ``gat_fused.launches`` (K6's sum kernel at H heads is its ``edges_to_rows_sum``)
    and K1's, as "K1 fwd" and "K1 bwd"."""
    from dgll_tpu_torch.ops.cuda import edge_ops as tk
    from dgll_tpu_torch.ops.cuda import gat_fused as gf
    from dgll_tpu_torch.ops.cuda import segment_matmul as sm

    return {**tk.launches, **gf.launches, "K1 fwd": sm.launches_fwd,
            "K1 bwd": sm.launches_bwd}


def _zero_counters() -> None:
    from dgll_tpu_torch.ops.cuda import edge_ops as tk
    from dgll_tpu_torch.ops.cuda import gat_fused as gf
    from dgll_tpu_torch.ops.cuda import segment_matmul as sm

    for counts in (tk.launches, gf.launches):
        for k in counts:
            counts[k] = 0
    sm.launches_fwd = sm.launches_bwd = 0


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


def phase_quantize_time() -> dict:
    """Phase 16: K8 at the int8 cache's fill shape (50,000 x 256, no noise, "xla"
    mode, what ``HBMFeatureCache.fill`` runs), beside its plain version,
    ``torch.fake_quantize_per_channel_affine`` over [-127, 127] (the same rounding to
    a float result; the port never calls it) and its bound: x read, q written and
    the scales, 4 float32 operations per value. Also with supplied noise."""
    from dgll_tpu_torch.ops import quantize as q
    from dgll_tpu_torch.ops.cuda.quantize import quantize_int8_cuda

    gen = torch.Generator(device="cuda").manual_seed(17)
    x = _quantize_inputs(50_000, 256, gen)
    scale = q.column_scale(x)
    zero = torch.zeros(256, dtype=torch.int32, device="cuda")
    noise = torch.rand(x.shape, generator=gen, device="cuda") - 0.5
    result = {}
    for label, u in (("fill", None), ("supplied noise", noise)):
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
    g, _, cache, fetch = run.prepare_pipeline(cfg, g, PhaseTimer(), {}, dev, get_logger())
    n_class = int(g.labels[: g.n_real_node].max()) + 1
    model = run.build_model(cfg, n_class, g.node_feat.shape[1],
                            generator=torch.Generator().manual_seed(0))
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
    1e-5; the int8 run counts exactly one K8 launch (its one fill)."""
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
        k = cache.auto_cache(out_degree, budget)
        launches = k8.launches
        losses, ms = run(cache.fetch)
        check(k8.launches == launches, "fetch launches no K8")
        row = {"losses": losses, "ms_per_batch": ms, "miss_rate": cache.miss_rate()[0],
               "cached_rows": k, "byte_budget_mb": budget / 1e6, "k8_launches": launches}
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


def _probe_edge_cases() -> None:
    """Phase 19: the probe kernels on ragged shapes against their plain versions, at
    the probes' bars: row counts that no tile, chunk or unroll divides, narrow and odd
    widths, and for P2b an index outside the window (a zero row)."""
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
    torch.cuda.synchronize()
    print(f"[19 probes] {len(cases)} ragged cases (rows 21-1001, widths 4-128, an index "
          f"outside P2b's window) agree with the plain versions")


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


def phase_probe_kernels() -> dict:
    """Phase 19: each probe's kernel (``csrc/probes.cu``, uncounted launches) against
    its plain version at the script's full sizes (``tools/probe.make_data`` and
    ``probe_calls``): P0, P2 and P4 exactly, P2b elementwise within rtol 1e-5, P3
    within rtol 1e-4 and 1e-5 x max|ref| (``tools/probe.max_error``); then each timed
    beside its plain version, one library call (``copy_``, ``index_select``,
    ``index_add_``) and its bound; then P3 under contention. A gather's bytes count the
    table rows its ids touch. P2b's bound is the larger of its bytes and the function's
    one product (2 x E x WIN x F operations) at TF32's 495 TFLOP/s: splitting win
    into hi + lo is the kernel's way to f32 accuracy, not work the function needs."""
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

        err = probe.max_error(key, kernel(), plain(*args))
        torch.cuda.synchronize()
        t = {"ms": cuda_median_ms(kernel), "plain_ms": cuda_median_ms(lambda: plain(*args)),
             "library_ms": cuda_median_ms(library)}
        t["bound_ms"], t["bound_by"] = bound(moved, ops, rate)
        result[key] = {"err": err, "times": t}
        print(f"[19 probes] {key}: max abs err {err:.3e} against its plain version; "
              f"{describe(t)}; {moved / (t['ms'] * 1e-3) / 1e9:.1f} GB/s moved")
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


def kernel_row(name, source, replaces, launches, err, t) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}


def main() -> int:
    smi = phase_env()
    phase_build()
    worst = phase_check()
    times = phase_time()
    sl = phase_slice()
    gat_errs = {}  # max abs error per kernel, test graph and slice's shapes
    phase_gat_check(gat_errs)
    phase_gat_layer()
    gat_times = phase_gat_time(gat_errs)
    gat_counts = phase_gat_slice()
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
        "quantize_int8 (K8: per-column int8, the int8 cache's fill)", QUANTIZE_SOURCE,
        QUANTIZE_REPLACES, cache["budget_6.25pct_int8"]["k8_launches"], k8_err,
        k8_times["fill"]))
    for name, key, line in PROBE_KERNELS:
        kernels.append(kernel_row(name, PROBES_SOURCE, f"{PROBE_SCRIPT}:{line}",
                                  probe_counts[key], probe_kernels[key]["err"],
                                  probe_kernels[key]["times"]))
    print(f"[15 layers] {json.dumps(r4['layers'])}")
    print(f"[17 cli] {json.dumps(minibatch)}")
    print(f"[18 cache] {json.dumps(cache)}")
    print(f"[19 probes] {json.dumps(probe_res)}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
