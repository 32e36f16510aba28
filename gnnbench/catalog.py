"""The harness's files, found by name: ``workloads/<cell>.json`` (a configuration, a
traffic mix, the chips and the check's limits), ``configs/<name>.json``,
``traffic/<name>.json`` and ``metrics/<name>.py`` (a per-layer metric's reader)."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
METRIC_KEYS = ("UNIT", "BETTER", "SOURCE", "LAYER", "MOVES")


def _json(kind: str, name: str, root: Path) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"gnnbench: no {kind} file {path}")
    with open(path) as fh:
        return json.load(fh)


def workload(name: str, root: Path = HERE) -> dict:
    return {"name": name, **_json("workloads", name, root)}


def config(name: str, root: Path = HERE) -> dict:
    return {"name": name, **_json("configs", name, root)}


def names(kind: str, suffix: str, root: Path = HERE) -> List[str]:
    return sorted(p.name[: -len(suffix)] for p in (root / kind).glob(f"*{suffix}"))


def metric(name: str, root: Path = HERE):
    """The reader module of per-layer metric ``name`` (``metrics/<name>.py``): its
    ``UNIT``, ``BETTER``, ``SOURCE``, ``LAYER``, ``MOVES`` and ``read(run)``."""
    spec = importlib.util.spec_from_file_location(f"gnnbench_metric_{name}",
                                                  root / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [k for k in METRIC_KEYS + ("read",) if not hasattr(mod, k)]
    if missing:
        raise ValueError(f"metric {name} lacks {missing}")
    return mod


def metrics(root: Path = HERE) -> Dict[str, object]:
    return {n: metric(n, root) for n in names("metrics", ".py", root)}


def listing(root: Path = HERE) -> dict:
    """Every cell with its configuration and traffic, every configuration and traffic
    mix, and every per-layer metric with what it declares."""
    return {
        "workloads": {n: {k: v for k, v in workload(n, root).items() if k != "name"}
                      for n in names("workloads", ".json", root)},
        "configs": names("configs", ".json", root),
        "traffic": names("traffic", ".json", root),
        "metrics": {n: {k.lower(): getattr(m, k) for k in METRIC_KEYS}
                    for n, m in metrics(root).items()},
    }
