"""Tests of the benchmark's harness. They run the harness's whole path on the CPU at
a few thousand nodes (``--dry-run``), each in a fresh process, as a run on the chip
imports it. Tests that need a CUDA card carry the ``card`` marker, registered here,
and skip where there is none; each decides inside the test, never at import.

    python -m pytest gnnbench/tests -q          # here: the CPU tests, card tests skip
    python -m pytest gnnbench/tests -q -m card  # on the machine with the card
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the machine with the H100")
    return torch.device("cuda")


def run_python(args, cwd=ROOT, timeout=300, pythonpath=None):
    """``python args`` in a fresh process with few threads; returns the completed
    process (stdout and stderr as text)."""
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(p for p in (pythonpath, str(ROOT)) if p)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.fixture
def python():
    return run_python
