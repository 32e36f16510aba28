"""A new cell, configuration and per-layer metric are new files and nothing else:
in a copy of the harness, three files are added, no file is edited, and the harness
lists them and runs the new cell (its dry run) with the new metric read."""
import hashlib
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_config_and_metric_are_files(python, tmp_path):
    copy = tmp_path / "gnnbench"
    shutil.copytree(ROOT / "gnnbench", copy, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(copy)
    (copy / "configs" / "sage2-64.json").write_text(json.dumps({
        "arch": "graphsage", "source": "https://arxiv.org/abs/1706.02216", "n_layers": 2,
        "hidden": 64, "aggregator": "mean", "combine": "concat", "dropout": 0.0,
        "lr": 0.001, "weight_decay": 0.0, "dtype": "float32", "reduced": []}))
    (copy / "workloads" / "sage2-64.products.json").write_text(json.dumps({
        "config": "sage2-64", "traffic": "products", "chips": 1,
        "limits": {"loss_gap": 1e-3, "grad_gap": 1e-3, "median_change_gap": 1e-3}}))
    (copy / "metrics" / "train_seeds_per_epoch.minibatch.py").write_text(
        'UNIT = "seeds"\nBETTER = "higher"\nSOURCE = "program_counter"\n'
        'LAYER = "device epoch runner"\n'
        'MOVES = "train_seeds_per_s"\n\n\n'
        'def read(run):\n'
        '    return run.traffic.n_train if run.traffic.mode == "minibatch" else None\n')
    res = python(["-m", "gnnbench.run", "--list"], cwd=tmp_path, pythonpath=str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    listing = json.loads(res.stdout)
    assert listing["workloads"]["sage2-64.products"]["config"] == "sage2-64"
    assert "sage2-64" in listing["configs"]
    assert listing["metrics"]["train_seeds_per_epoch.minibatch"]["moves"] == "train_seeds_per_s"
    res = python(["-m", "gnnbench.run", "--dry-run", "--workload", "sage2-64.products",
                  "--seconds", "0", "--seed", "5"], cwd=tmp_path, pythonpath=str(tmp_path))
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and "train_seeds_per_epoch.minibatch" in out["read"]
    after = _digests(copy)
    assert {k: after[k] for k in before} == before  # no file of the harness edited
    assert sorted(set(after) - set(before)) == [
        "configs/sage2-64.json", "metrics/train_seeds_per_epoch.minibatch.py",
        "workloads/sage2-64.products.json"]
