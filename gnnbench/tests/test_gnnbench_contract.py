"""``BENCHMARK.json`` says what the harness's files say: every cell, configuration and
per-layer metric it names is a file of the harness with the same declarations."""
import json
import re
from pathlib import Path

from gnnbench import catalog

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_cells_and_configs_are_files():
    b = _bench()
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"] == f"gnnbench/configs/{c['name']}.json"
        assert c["source"] == cfg["source"] and c["reduced"] == cfg["reduced"]
    for w in b["workloads"]:
        cell = catalog.workload(w["name"])
        assert (w["config"], w["traffic"], w["chips"]) == (
            cell["config"], cell["traffic"], cell["chips"])
        assert len(w["why"]) <= 200
    assert {w["config"] for w in b["workloads"]} == {c["name"] for c in b["configs"]}


def test_metrics_are_files():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        mod = catalog.metric(m["name"])
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
            mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES), m["name"]
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    names = [m["name"] for m in b["per_layer"] + b["end_to_end"]] + [
        w["name"] for w in b["workloads"]] + [c["name"] for c in b["configs"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)


def test_end_to_end_metrics_and_bounds():
    b = _bench()
    by_name = {m["name"]: m for m in b["end_to_end"]}
    assert by_name["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert b["command"] == ["python3", "-m", "gnnbench.run"] and b["paths"] == ["gnnbench"]
