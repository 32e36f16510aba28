"""P4's design sweep on a CUDA device: the bucketed gather's bucket size and launch,
and where each of P4's two paths wins.

    python -m dgll_tpu_torch.tools.p4_sweep [--seed 0]

Every call goes through ``ops.cuda.probes.p4_dma_cuda`` with an explicit plan
(``ops.probes.P4Plan``), and is first checked exactly against ``p4_dma_reference``:

* ``launch``: at the probe's size ([500000, 128] float32, 2^22 uniform ids) the
  bucketed path at buckets of 1 to 16 MB of table and at several gather launches
  (blocks an SM, threads a block, loads a lane issues at once), and the direct path
  at its launches;
* ``rule``: both paths (their plans' launches) and ``index_select`` where the plan's
  rule draws its lines: 0.5 to 8.4 draws a row at [500000, 128]; tables of 12.8 to
  102.4 MB at 8 draws a row; rows of 400 bytes ([2400000, 100]) at 3 draws a row;
  GAT's shape ([200000, 64], 5,369,806 uniform ids); and a permutation of a
  [2^22, 128] table beside the same ids in order, where no row is drawn twice (the
  direct path then reads at random, the bucketed path writes at random).

Times are medians of ``REPS`` CUDA-event timings after 3 warm-ups, in ms. Each sweep
prints one JSON line; the last line is one JSON object with everything and the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import torch

from dgll_tpu_torch.ops import probes
from dgll_tpu_torch.ops.cuda.probes import p4_dma_cuda
from dgll_tpu_torch.utils.profiling import cuda_median_ms

REPS = 9
BUCKET_MB = (1, 2, 4, 8, 16)
# (blocks an SM, threads a block, loads a lane issues at once)
BUCKETED_LAUNCHES = ((1, 256, 4), (2, 256, 4), (1, 256, 16), (2, 128, 8), (2, 128, 16),
                     (4, 64, 16), (4, 128, 16))
DIRECT_LAUNCHES = ((2, 256, 8), (4, 256, 4), (8, 256, 4), (4, 128, 16))
RULE_SHAPES = (  # (rows, F, E)
    (500_000, 128, 250_000), (500_000, 128, 500_000), (500_000, 128, 1_000_000),
    (500_000, 128, 2_000_000), (500_000, 128, 1 << 22),
    (25_000, 128, 200_000), (50_000, 128, 400_000), (100_000, 128, 800_000),
    (200_000, 128, 1_600_000), (2_400_000, 100, 7_200_000), (200_000, 64, 5_369_806))


def _gather(x, ids, plan, want) -> float:
    if not torch.equal(p4_dma_cuda(ids, x, plan), want):
        raise AssertionError(f"P4 differs from its plain version: {tuple(x.shape)}, "
                             f"{ids.numel()} ids, {plan}")
    return cuda_median_ms(lambda: p4_dma_cuda(ids, x, plan), reps=REPS)


def sweep_launch(gen) -> dict:
    rows, f, e = 500_000, 128, 1 << 22
    x = torch.randn(rows, f, generator=gen, device="cuda")
    ids = torch.randint(0, rows, (e,), dtype=torch.int32, generator=gen, device="cuda")
    want = probes.p4_dma_reference(ids, x)
    res = {"index_select": cuda_median_ms(lambda: x.index_select(0, ids), reps=REPS)}
    for mb in BUCKET_MB:
        plan = probes.p4_bucketed_plan(rows, f, mb << 20)
        for launch in BUCKETED_LAUNCHES:
            res[f"bucketed {mb} MB {launch}"] = _gather(
                x, ids, dataclasses.replace(plan, blocks_per_sm=launch[0], threads=launch[1],
                                            unroll=launch[2]), want)
    for launch in DIRECT_LAUNCHES:
        res[f"direct {launch}"] = _gather(x, ids, probes.P4Plan(False, -1, 0, *launch), want)
    return res


def sweep_rule(gen) -> dict:
    res = {}
    shapes = [(rows, f, torch.randint(0, rows, (e,), dtype=torch.int32, generator=gen,
                                      device="cuda")) for rows, f, e in RULE_SHAPES]
    n = 1 << 22
    perm = torch.randperm(n, generator=gen, device="cuda").to(torch.int32)
    shapes += [(n, 128, perm), (n, 128, torch.arange(n, dtype=torch.int32, device="cuda"))]
    for k, (rows, f, ids) in enumerate(shapes):
        x = torch.randn(rows, f, generator=gen, device="cuda")
        want = probes.p4_dma_reference(ids, x)
        e = ids.numel()
        label = f"[{rows}, {f}] E={e}" + (" permutation" if k == len(shapes) - 2 else
                                          " in order" if k == len(shapes) - 1 else "")
        res[label] = {
            "draws": e / rows, "table_mb": rows * f * 4 / 1e6,
            "plan": "bucketed" if probes.p4_plan(rows, f, e).bucketed else "direct",
            "direct": _gather(x, ids, probes.P4Plan(False), want),
            "bucketed": _gather(x, ids, probes.p4_bucketed_plan(rows, f), want),
            "index_select": cuda_median_ms(lambda: x.index_select(0, ids), reps=REPS)}
        del x, want
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0, help="seed of the generated data")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("p4_sweep measures a CUDA device; none is available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"card": card}
    for name, fn in (("launch", sweep_launch), ("rule", sweep_rule)):
        result[name] = fn(gen)
        print(json.dumps({name: result[name]}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
