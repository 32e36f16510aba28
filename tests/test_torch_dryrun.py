"""The port's multi-rank dry run (``dgll_tpu_torch.entry.dryrun_multichip``) against
the JAX package's (``__graft_entry__.py:dryrun_multichip``), on the CPU.

``dryrun_multichip(2, device="cpu")`` starts two ranks over gloo and runs the nine
flows; its line has the JAX line's keys in the JAX line's order and ends in ``OK``,
every loss is finite, and ``auto_strategy``, ``windowed_fraction`` and ``tp_out``'s
shape equal those of JAX's ``dryrun_multichip(2)`` on the 2-device virtual mesh (its
line captured from its standard output). The graph-partition flows start from the
same parameters (``default_rng(0)``), so ``gp_loss`` (the halo GCN's loss before its
Adam step) and ``windowed_halo_loss`` (after it) agree with JAX's within 2e-4, the
lines' rounding to 4 decimals plus float32 sums in another order; the other losses
start from each package's own initialisation and draws, and are only finite.
"""
import contextlib
import importlib.util
import io
import math
import re
from pathlib import Path

import pytest

from dgll_tpu_torch.entry import dryrun_multichip

REPO = Path(__file__).resolve().parents[1]
FIELD = re.compile(r"(\w+)=(\([^)]*\)|[^\s()]+)")
LOSSES = ("dp_loss", "async_dp_loss", "gp_loss", "device_epoch_loss",
          "dp_device_sampling_loss", "dp_device_fastgcn_loss", "windowed_halo_loss")


def _jax_line() -> str:
    spec = importlib.util.spec_from_file_location("jax_entry", REPO / "__graft_entry__.py")
    ge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ge)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ge.dryrun_multichip(2)
    return out.getvalue().strip().splitlines()[-1]


@pytest.fixture(scope="module")
def lines():
    port = io.StringIO()
    with contextlib.redirect_stdout(port):
        line = dryrun_multichip(2, device="cpu", timeout=120)
    assert port.getvalue().strip() == line  # the parent prints rank 0's line
    return line, _jax_line()


def test_dryrun_line_has_the_jax_lines_keys_and_ends_in_ok(lines):
    port, jax_line = lines
    assert port.startswith("dryrun_multichip(2): ") and port.endswith(" OK")
    assert [k for k, _ in FIELD.findall(port)] == [k for k, _ in FIELD.findall(jax_line)]


def test_dryrun_losses_are_finite(lines):
    got = dict(FIELD.findall(lines[0]))
    for k in LOSSES:
        assert math.isfinite(float(got[k])), (k, got[k])


def test_dryrun_agrees_with_jax(lines):
    got, want = (dict(FIELD.findall(line)) for line in lines)
    for k in ("auto_strategy", "windowed_fraction", "tp_out"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["tp_out"] == "(128, 8)"
    for k in ("gp_loss", "windowed_halo_loss"):
        assert abs(float(got[k]) - float(want[k])) <= 2e-4, (k, got[k], want[k])
