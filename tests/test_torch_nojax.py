"""The port runs without JAX: the machine with the GPU has none.

A subprocess in which ``jax``, ``flax``, ``optax`` and the JAX package cannot be
imported imports every module of ``dgll_tpu_torch``, trains a few full-batch epochs
through the CLI, runs the full-graph bench on a small clustered graph through the
windowed layout, and runs the community pipeline through the shared C++ host
kernels. No source file of the package imports them either.
``chip_smoke.py`` refuses to run, and prints no result, without a CUDA device.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import dgll_tpu_torch

REPO = Path(__file__).resolve().parents[1]
PACKAGE = Path(dgll_tpu_torch.__file__).resolve().parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "dgll_tpu")

_NO_JAX = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of these now raises ImportError
import dgll_tpu_torch
for m in pkgutil.walk_packages(dgll_tpu_torch.__path__, "dgll_tpu_torch."):
    importlib.import_module(m.name)
from dgll_tpu_torch.run import main
out = main(["--samp_type", "full", "--device", "cpu", "--n_node", "300",
            "--n_epochs", "2", "--nhid", "16", "--feat_dim", "8"])
assert out["trials"][0]["epochs"] == 2
import os
os.environ["BENCH_FG_NODES"] = "4096"
from dgll_tpu_torch.bench import clustered_graph, fullgraph_step
r = fullgraph_step("cpu")
assert r["kernel"] == "windowed_hybrid" and r["steps"] == 14, r
from dgll_tpu_torch import native
from dgll_tpu_torch.parallel.community import run_cog
assert native.native_available()
g, book, _ = run_cog(clustered_graph(8192, 4), batch_size=512)
assert g.node_perm is not None and len(book) > 1
print("NOJAX_OK")
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_package_imports_and_trains_without_jax():
    proc = _run(["-c", _NO_JAX], REPO)
    assert proc.returncode == 0, proc.stderr
    assert "NOJAX_OK" in proc.stdout


def test_no_source_imports_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|dgll_tpu)\b",
                         re.MULTILINE)
    offenders = [str(p.relative_to(REPO)) for p in PACKAGE.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
    assert not pattern.search((REPO / "chip_smoke.py").read_text())


def test_chip_smoke_fails_without_a_card():
    proc = _run([str(REPO / "chip_smoke.py")], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
