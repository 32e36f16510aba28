"""A run loads neither JAX nor the JAX package, and reads nothing of the JAX
package's benchmarks (``benchmarks/``, the root ``bench.py``, ``BENCH_*.json``).
Module names are compared by their top-level name, whole: ``dgll_tpu_torch`` is the
port, ``dgll_tpu`` the JAX package."""
import json
from pathlib import Path

import pytest

from gnnbench import catalog

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "dgll_tpu"}


@pytest.mark.parametrize("cell", catalog.names("workloads", ".json"))
def test_run_imports_and_reads(python, cell):
    res = python(["gnnbench/tests/_audit_child.py", "--dry-run", "--workload", cell,
                  "--seconds", "0", "--seed", "11"])
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0
    assert not FORBIDDEN & set(out["modules"]), sorted(FORBIDDEN & set(out["modules"]))
    assert "dgll_tpu_torch" in out["modules"]
    for path in out["opened"]:
        p = Path(path).resolve()
        if ROOT not in p.parents:
            continue
        rel = p.relative_to(ROOT)
        assert rel.parts[0] != "benchmarks", rel
        assert str(rel) != "bench.py" and not (len(rel.parts) == 1 and rel.name.startswith("BENCH_")), rel
        assert rel.parts[0] != "dgll_tpu", rel


def test_reference_imports_nothing_of_the_program():
    """The plain reference and the yardstick import only torch, numpy and themselves."""
    import ast

    allowed = {"torch", "numpy", "gnnbench", "__future__", "dataclasses", "typing",
               "math", "json", "pathlib", "bisect", "time", "collections", "re"}
    files = list((ROOT / "gnnbench" / "reference").glob("*.py")) + [
        ROOT / "gnnbench" / f for f in ("check.py", "counts.py", "traffic.py", "weights.py")]
    for f in files:
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            for n in names:
                assert n.split(".")[0] in allowed, f"{f.name} imports {n}"
