"""The readings that a cell's limits are set from, on the chip at the cell's own size.

    python -m gnnbench.calibrate --workload <cell> --seeds 1,2,3[,...]

For each seed, in one process: the cell's set-up (its data, the port's training
object and the check's three steps, as a run makes them), then the numbers that
``check.readings`` compares for

* ``program``: the port against the reference (the lower reading is the largest
  over the seeds);
* ``control``: the reference computed with TF32 products, the nearest precision
  below the configuration's float32, in the program's place;
* ``half_batch``: the reference with the second half of each batch (full batch: of
  the train nodes) left out of the loss, the mean taken over the rest;
* ``unchanged``: a step that returns its state unchanged (the loss of the first
  step three times, no gradient, no change).

One JSON line a seed, then one line with each number's lower reading and each
control's and fault's smallest.
"""
from __future__ import annotations

import argparse
import json
import sys

KINDS = ("program", "control", "half_batch", "unchanged")


def seed_readings(name: str, seed: int, scaled: bool = False) -> dict:
    """The readings of one seed; ``scaled``: at a test's size (``Traffic.scaled``)."""
    import torch

    from gnnbench import catalog, check, modes, traffic
    from dgll_tpu_torch.run import resolve_device

    cell = catalog.workload(name)
    cfg = catalog.config(cell["config"])
    mix = traffic.load(cell["traffic"])
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if scaled or dev.type == "cpu":
        mix = mix.scaled()
    resolve_device(str(dev))
    run = modes.driver(mix.mode)(cfg, mix, traffic.streams(seed), dev)
    run.setup()
    run.free_program()

    def against_reference(prog):
        return check.readings(prog, run.reference(follow=prog))

    still = check.trajectory([0.0] * 3, {k: torch.zeros_like(v) for k, v in run.weights.items()},
                             [run.weights] * 4)
    still.losses = run.reference(follow=still).losses  # what a step that moves nothing reads
    ref = run.reference(follow=run.prog)
    out = {"seed": seed,
           "program": check.readings(run.prog, ref),
           "control": against_reference(run.reference(tf32=True)),
           "half_batch": against_reference(run.reference(half_batch=True)),
           "unchanged": against_reference(still),
           "worst_leaf": {k: max(v.items(), key=lambda kv: kv[1])
                          for k, v in check.leaf_gaps(run.prog, ref).items()
                          if isinstance(v, dict)}}
    del run
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def summary(rows: list) -> dict:
    from gnnbench.check import NAMES

    out = {}
    for n in NAMES:
        out[n] = {"lower": max(r["program"][n] for r in rows),
                  **{k: min(r[k][n] for r in rows) for k in KINDS[1:]}}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = p.parse_args(argv)
    rows = []
    for s in args.seeds.split(","):
        rows.append(seed_readings(args.workload, int(s)))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
