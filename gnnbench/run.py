"""Run one cell of the benchmark and print its result as the last line of stdout.

    python -m gnnbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python -m gnnbench.run --list
    python -m gnnbench.run --dry-run --workload <cell> [--seed n] [--seconds s]

From the root of a checkout. A run makes the cell's data and weights from ``--seed``
on the card, builds the port's training object and drives its first three steps for
the check, warms the window's path up (``setup_s`` is everything from the start of
this module to here), trains for ``--seconds`` (the end-to-end metrics), and with
``--trace 1`` then traces a bounded slice for the per-layer metrics. Last, with the
port's state freed, the plain reference follows the program's three steps, each from
the program's own parameters before it, and ``correct`` says whether every compared
number is within its limit; the numbers and limits are
the last lines of stderr and the last key of the result.

A run needs a CUDA card (it exits 2 without one, printing no result) and imports no
module named ``jax``, ``jaxlib``, ``flax`` or ``dgll_tpu`` (it exits 3 where one is
loaded once the window has closed). ``--dry-run`` runs the same path on the CPU at a
few thousand nodes and prints which checks and metrics it reached, no measurement.
Build and kernel caches go under ``build/`` in the checkout.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dgll_tpu")
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "TORCHINDUCTOR_CACHE_DIR": "inductor"}


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run must not load, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or "" where it
    cannot."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else ""


def _log(msg: str) -> None:
    print(f"[gnnbench] {msg}", file=sys.stderr, flush=True)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", help="a cell: gnnbench/workloads/<name>.json")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    p.add_argument("--list", action="store_true", help="list cells, configs, metrics")
    p.add_argument("--dry-run", action="store_true",
                   help="the run's path on the CPU at a tiny size, no measurement")
    return p.parse_args(argv)


def per_layer(run) -> dict:
    """Every per-layer metric whose reader finds something to read in this run."""
    from gnnbench import catalog

    out = {}
    for name, m in catalog.metrics().items():
        value = m.read(run)
        if value is not None:
            out[name] = {"value": float(value), "unit": m.UNIT}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from gnnbench import catalog

    if args.list:
        print(json.dumps(catalog.listing()))
        return 0
    if not args.workload:
        _log("--workload is required")
        return 1
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "gnnbench" / sub)

    import torch

    from gnnbench import check, counts, modes, traffic

    cell = catalog.workload(args.workload)
    cfg = catalog.config(cell["config"])
    mix = traffic.load(cell["traffic"])
    if args.dry_run:
        dev = torch.device("cpu")
        mix = mix.scaled()
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            _log(f"needs {cell['chips']} CUDA device(s); "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
            return 2
        dev = torch.device("cuda")
    from dgll_tpu_torch.run import resolve_device

    resolve_device(str(dev))  # the CLI's rule: float32 products stay out of TF32
    run = modes.driver(mix.mode)(cfg, mix, traffic.streams(args.seed), dev)
    run.setup()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    _log(f"set-up {setup_s:.3f} s (layout build {run.layout_build_s:.3f} s)")
    res = run.window(args.seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    metrics = {"setup_s": {"value": setup_s, "unit": "s"}, **res["metrics"]}
    run.device_name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    run.peaks = counts.peaks(run.device_name) if cuda else None
    limit = power_limit() if cuda else ""
    breakdown = None
    if args.trace and cuda:
        run.traced()
        metrics = per_layer(run)
        breakdown = run.trace.breakdown()
        for name, m in metrics.items():
            _log(f"{name} = {m['value']} {m['unit']} ({limit})")
    run.free_program()
    if cuda:
        torch.cuda.empty_cache()
    values = check.readings(run.prog, run.reference(follow=run.prog))
    correct, checks = check.judge(values, cell["limits"])
    correct = correct and res["failed"] == 0  # a window's loss that is not finite
    bad = forbidden_modules()
    if bad:
        _log(f"loaded modules the benchmark must not load: {bad}")
        return 3
    if args.dry_run:
        read = sorted(n for n, m in catalog.metrics().items() if m.read(run) is not None)
        print(json.dumps({"dry_run": True, "correct": correct, "read": read,
                          "checks": checks}))
        return 0
    device = {"platform": "gpu", "kind": run.device_name, "count": 1,
              "memory_peak_bytes": int(peak), "power_limit": limit}
    if run.trace is not None:
        device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    for name, c in checks.items():
        _log(f"check {name} = {c['value']!r} (limit {c['limit']!r})")
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
