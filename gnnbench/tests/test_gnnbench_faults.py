"""The check catches the faults a training cell can have: the harness's whole run (a
dry run: the chip's look skipped) with the port's timed path broken underneath gives
``correct`` false; and the control, the reference in TF32 in the program's place,
fails the check on the card (TF32 exists only there)."""
import json

import pytest

from gnnbench import catalog

CELLS = catalog.names("workloads", ".json")


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(python, cell, fault):
    res = python(["gnnbench/tests/_fault_child.py", fault, "--dry-run", "--workload", cell,
                  "--seconds", "0", "--seed", "2718281828"])
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is False, out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    """At a test size on the card: the reference with TF32 products against the
    reference fails at least one of the cell's limits, on three seeds."""
    from gnnbench import calibrate, check

    limits = catalog.workload(cell)["limits"]
    for seed in (1, 2, 3):
        row = calibrate.seed_readings(cell, seed, scaled=True)
        assert check.judge(row["program"], limits)[0], row
        assert not check.judge(row["control"], limits)[0], row
