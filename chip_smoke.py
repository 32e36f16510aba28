#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

It builds the port's CUDA kernel from the sources in the checkout, holds it against
its plain PyTorch version on the card (on a power-law test graph, and through the
autograd wrapper at the shapes of the full-batch GCN slice), times both at the
slice's shapes, and then trains that slice for 20 epochs through the port's CLI
(``dgll_tpu_torch.run.main``). It needs one CUDA device and ``nvcc`` (``CUDA_HOME``
or ``PATH``), and no JAX.

Each phase prints its lines; a failed check raises and the script exits non-zero.
Before the last line it prints the card's name and power limit, as ``nvidia-smi``
gives them, and one JSON line describing the kernel. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

EPOCHS = 20  # phase 5 trains the slice for this many epochs
KERNEL_SOURCE = "dgll_tpu_torch/csrc/segment_matmul.cu"
REPLACES = "dgll_tpu/ops/pallas/segment_matmul.py:34"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


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
        bound = 1e-4 * want.abs().max().item()
        print(f"[4 check] F={f} {name} {tuple(got.shape)}: max abs err {err:.3e}, "
              f"tolerance {bound:.3e}")
        check(err <= bound, f"wrapper within tolerance at the slice's shapes (F={f}, {name})")
        worst = max(worst, err)
    return worst


def phase_time() -> dict:
    from dgll_tpu_torch.ops import spmm_chunked_reference
    from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_csr_cuda
    from dgll_tpu_torch.run import build_dataset
    from dgll_tpu_torch.tools.profile_slice import SLICE_ARGS
    from dgll_tpu_torch.utils import parse_train_config
    from dgll_tpu_torch.utils.profiling import cuda_median_ms

    g = build_dataset(parse_train_config(SLICE_ARGS)).with_chunked()
    c, ct = g.chunked.to("cuda"), g.chunked_t.to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    result = {}
    for f in (128, 16):
        err = _slice_check(c, ct, g.n_node, f, gen)
        for name, lay in (("A", c), ("A^T", ct)):
            x = torch.randn(lay.n_cols, f, generator=gen, device="cuda")
            k_ms = cuda_median_ms(lambda: spmm_csr_cuda(lay, x))
            p_ms = cuda_median_ms(lambda: spmm_chunked_reference(lay, x))
            nnz = lay.src.numel()
            gbs = (nnz * (f * 4 + 8) + lay.n_rows * f * 4) / (k_ms * 1e-3) / 1e9
            deg = int((lay.indptr[1:] - lay.indptr[:-1]).max())
            print(f"[4 time] F={f} {name}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
                  f"({p_ms / k_ms:.2f}x{'; kernel SLOWER than plain' if k_ms > p_ms else ''}),"
                  f" {gbs:.1f} GB/s of gathered rows + indices, {nnz} edges, "
                  f"max in-degree {deg}")
            result[(f, name)] = (k_ms, p_ms, err)
    return result


def phase_slice() -> dict:
    from dgll_tpu_torch import run
    from dgll_tpu_torch.ops.cuda import segment_matmul as sm
    from dgll_tpu_torch.tools.profile_slice import SLICE_ARGS

    torch.cuda.reset_peak_memory_stats()
    sm.launches_fwd = 0
    sm.launches_bwd = 0
    with contextlib.redirect_stdout(io.StringIO()):  # the CLI's own JSON line
        out = run.main([*SLICE_ARGS, "--n_epochs", str(EPOCHS)])
    fwd, bwd = sm.launches_fwd, sm.launches_bwd
    trial = out["trials"][0]
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
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches fwd {fwd} bwd {bwd}")
    return {"launches": fwd + bwd}


def main() -> int:
    smi = phase_env()
    phase_build()
    worst = phase_check()
    times = phase_time()
    sl = phase_slice()
    k_ms, p_ms, err = times[(128, "A")]
    kernels = {"kernels": [{
        "name": "spmm_csr (K1: weighted SpMM, fused bias + ReLU)",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": sl["launches"],
        "max_abs_err": max(worst, err),
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
