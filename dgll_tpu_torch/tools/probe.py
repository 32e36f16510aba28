"""Primitive-rate probe on a CUDA device: P0-P4 beside ``index_select``.

    python -m dgll_tpu_torch.tools.probe [--device cuda|cpu] [--seed 0]

Counterpart of ``benchmarks/pallas_probe_r4.py:main``. It measures each primitive a
gather-fused SpMM could be built from, through the port's probes (``ops/probes.py``,
kernels in ``csrc/probes.cu``), at the script's sizes: N 500,000 source rows of F 128
float32, E 2^22 gathered rows in chunks of EB 512, a window of WIN 256 rows, an
accumulator of OUT_TILE 8,192 rows.

  P0  streaming copy of [E, F]                (the achieved-bandwidth calibration)
  P1  index_select: f32 / bf16 / sorted ids   (the library gather, the yardstick)
  P2  window gather from shared memory
  P2b the same gather as a one-hot product on the tensor cores
  P3  scatter-add into the [OUT_TILE, F] accumulator
  P4  per-row asynchronous copy gather from device memory

All data is made on the device from ``torch.Generator(device).manual_seed(seed)``:
the arrays of the script's ``gen``; their ids are checked to lie in their tables
(the kernels do not check). Each probe is first checked against its plain version
(P0, P2, P4 exactly; P2b elementwise within rtol 1e-5; P3 within rtol 1e-4 and
1e-5 x max|ref|); a probe that fails raises. Then it is timed: CUDA events,
median of ``REPS`` after 3 warm-ups. ``dispatch_overhead_ms`` is the same timing of
the script's trivial op ``a[:8, :8]`` (a copy of it), and is subtracted from each
probe's time as the script does. Each probe row has ``ms``, ``ns_per_row`` and
``gbps`` (the script's bytes a row over the time).

``--device cuda`` (the default) raises without a card. ``--device cpu`` runs the
plain versions at the script's off-TPU sizes (N 4096, E 8192, one rep) to check the
control flow: its times are the host's, under ``"device": "cpu"``, and measure no
device. The last line is the JSON object.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from dgll_tpu_torch.ops import probes
from dgll_tpu_torch.ops.cuda.probes import check_index

N = 500_000          # source rows
F = 128              # feature width
E = 4_194_304        # gathered rows / edges per trial (2^22)
EB = 512             # edges per chunk
WIN = 256            # window rows (P2, P2b)
OUT_TILE = probes.OUT_TILE
REPS = 8
CPU_N, CPU_E = 4096, 8192   # --device cpu: the script's sizes off the TPU


def sizes(device: torch.device) -> tuple:
    """``(N, E, reps)`` on ``device``."""
    return (N, E, REPS) if device.type == "cuda" else (CPU_N, CPU_E, 1)


def make_data(device: torch.device, seed: int = 0) -> dict:
    """The script's arrays, made on ``device``: ``x32 [N, F]``, its bf16 copy, ids
    ``idx_flat [E]`` in [0, N) and sorted, ``idx_chunk`` in [0, WIN), ``idx_out`` in
    [0, OUT_TILE) and ``idx_hbm`` in [0, N), each ``[E / EB, EB]`` int32, ``msg
    [E, F]``, and the window ``win = x32[:WIN]``."""
    n, e, _ = sizes(device)
    nc = e // EB
    gen = torch.Generator(device).manual_seed(seed)
    kw = {"generator": gen, "device": device}
    x32 = torch.randn(n, F, **kw)
    idx_flat = torch.randint(0, n, (e,), dtype=torch.int32, **kw)
    idx_chunk = torch.randint(0, WIN, (nc, EB), dtype=torch.int32, **kw)
    idx_out = torch.randint(0, OUT_TILE, (nc, EB), dtype=torch.int32, **kw)
    idx_hbm = torch.randint(0, n, (nc, EB), dtype=torch.int32, **kw)
    msg = torch.randn(nc * EB, F, **kw)
    return {"x32": x32, "x16": x32.to(torch.bfloat16), "idx_flat": idx_flat,
            "idx_sorted": torch.sort(idx_flat).values, "idx_chunk": idx_chunk,
            "idx_out": idx_out, "idx_hbm": idx_hbm, "msg": msg, "win": x32[:WIN]}


def check_ids(d: dict) -> None:
    """Raise unless every id of ``d`` lies in its table (the kernels do not check)."""
    for key, rows in (("idx_chunk", d["win"].shape[0]), ("idx_out", OUT_TILE),
                      ("idx_hbm", d["x32"].shape[0])):
        check_index(key, d[key], rows)


def probe_calls(d: dict) -> dict:
    """Each probe of the port as ``(probe, plain version, args)``."""
    return {
        "p0_copy": (probes.p0_copy, probes.p0_copy_reference, (d["msg"],)),
        "p2_dynread": (probes.p2_dynread, probes.p2_dynread_reference,
                       (d["idx_chunk"], d["win"])),
        "p2b_onehot": (probes.p2b_onehot, probes.p2b_onehot_reference,
                       (d["idx_chunk"].reshape(-1, 1), d["win"])),
        "p3_dynacc": (probes.p3_dynacc, probes.p3_dynacc_reference, (d["idx_out"], d["msg"])),
        "p4_dma": (probes.p4_dma, probes.p4_dma_reference, (d["idx_hbm"], d["x32"])),
    }


def max_error(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest absolute difference of probe ``name`` from its plain version;
    raises where it is beyond the probe's bar: none for P0, P2 and P4; rtol 1e-5 a
    value for P2b; for P3 (L2 atomics, sums in another order) rtol 1e-4 plus 1e-5 x
    max|ref|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} against "
                             f"{want.dtype} {tuple(want.shape)}")
    diff = (got - want).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if name == "p2b_onehot":
        ok = bool((diff <= 1e-5 * want.abs()).all())
    elif name == "p3_dynacc":
        ok = bool((diff <= 1e-4 * want.abs() + 1e-5 * float(want.abs().max())).all())
    else:
        ok = torch.equal(got, want)
    if not ok:
        raise AssertionError(f"{name}: differs from its plain version, max abs {err:.3e}")
    return err


def median_ms(fn, device: torch.device, reps: int) -> float:
    """Median ms of ``fn()``: CUDA events after 3 warm-ups on a CUDA device, the host
    clock after one on the CPU."""
    if device.type == "cuda":
        from dgll_tpu_torch.utils.profiling import cuda_median_ms

        return cuda_median_ms(fn, warmup=3, reps=reps)
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(device: torch.device, seed: int = 0) -> dict:
    n, e, reps = sizes(device)
    d = make_data(device, seed)
    check_ids(d)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    res = {"device": name, "N": n, "F": F, "E": e, "EB": EB}
    calls = probe_calls(d)
    for key, (fn, plain, args) in calls.items():
        max_error(key, fn(*args), plain(*args))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    x32 = d["x32"]
    t_over = median_ms(lambda: x32[:8, :8].clone(), device, reps)
    res["dispatch_overhead_ms"] = t_over

    def rate(label, t, rows, bytes_per_row):
        per = max(t - t_over, 1e-6)
        res[label] = {"ms": per, "ns_per_row": per * 1e6 / rows,
                      "gbps": rows * bytes_per_row / (per * 1e-3) / 1e9}

    take = torch.Tensor.index_select
    timed = [
        ("p0_stream_copy", calls["p0_copy"], 2 * F * 4),
        ("p1_take_f32", (take, None, (x32, 0, d["idx_flat"])), F * 4),
        ("p1_take_bf16", (take, None, (d["x16"], 0, d["idx_flat"])), F * 2),
        ("p1_take_f32_sorted", (take, None, (x32, 0, d["idx_sorted"])), F * 4),
        ("p2_dynread", calls["p2_dynread"], F * 4),
        ("p2b_onehot", calls["p2b_onehot"], F * 4),
        ("p3_dynacc", calls["p3_dynacc"], F * 4),
        ("p4_row_dma", calls["p4_dma"], F * 4),
    ]
    for label, (fn, _, args), bytes_per_row in timed:
        rate(label, median_ms(lambda: fn(*args), device, reps), e, bytes_per_row)
        print(label, "->", res[label], flush=True)
    return res


def main(argv=None) -> dict:
    from dgll_tpu_torch.run import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--seed", type=int, default=0, help="seed of the generated data")
    args = p.parse_args(argv)
    res = run(resolve_device(args.device), args.seed)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
