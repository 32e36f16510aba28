"""Every cell's path, from the data to the check, on the CPU at a tiny size."""
import json

import pytest

from gnnbench import catalog

CELLS = catalog.names("workloads", ".json")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_dry_run_is_correct(python, cell):
    res = python(["-m", "gnnbench.run", "--dry-run", "--workload", cell, "--seconds", "0",
                  "--seed", "3000000019"])
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["dry_run"] and out["correct"], out
    assert set(out["checks"]) == {"loss_gap", "grad_gap", "median_change_gap"}
    assert "layout_build_s" in out["read"]
    assert "[gnnbench] set-up" in res.stderr


def test_list_names_every_file(python):
    res = python(["-m", "gnnbench.run", "--list"])
    assert res.returncode == 0, res.stderr
    listing = json.loads(res.stdout)
    assert sorted(listing["workloads"]) == CELLS
    for cell in listing["workloads"].values():
        assert cell["config"] in listing["configs"]
        assert cell["traffic"] in listing["traffic"]


def test_no_card_no_result(python):
    """Without a CUDA card a run exits non-zero and prints nothing on stdout."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    res = python(["-m", "gnnbench.run", "--workload", CELLS[0], "--seed", "1",
                  "--seconds", "1", "--trace", "0"])
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_same_seed_same_data():
    import torch

    from gnnbench import traffic

    mix = traffic.load("products").scaled(n_node=500)
    a = traffic.make(mix, traffic.streams(2**31 + 5), "cpu")
    b = traffic.make(mix, traffic.streams(2**31 + 5), "cpu")
    c = traffic.make(mix, traffic.streams(2**31 + 6), "cpu")
    assert torch.equal(a.csr_src, b.csr_src) and torch.equal(a.feats, b.feats)
    assert not torch.equal(a.feats, c.feats)


def test_published_edge_counts():
    from gnnbench import traffic

    assert traffic.load("products").n_edge == 123_718_280
    assert traffic.load("arxiv-full").n_edge == 2_501_829
    mix = traffic.load("arxiv-full").scaled(n_node=700)
    src, dst = traffic.edges(mix, 7, "cpu")
    assert src.numel() == mix.n_edge and int((src == dst).sum()) == mix.n_node


@pytest.mark.parametrize("change", [{"dtype": "bfloat16"}, {"out_heads": 8},
                                    {"activation": "relu"}, {"residual": True}])
def test_config_states_only_what_runs(change):
    """A configuration may state no key that neither side reads, and no value of a
    fixed key (``dtype``, the output heads, the activation) other than the built one."""
    from gnnbench import reference
    from gnnbench.reference import gat

    cfg = catalog.config("gat8x8")
    reference.refuse_unbuilt(cfg, gat.READS, gat.FIXED)
    with pytest.raises(ValueError, match="no run"):
        reference.refuse_unbuilt(dict(cfg, **change), gat.READS, gat.FIXED)


@pytest.mark.parametrize("name", CELLS)
def test_shipped_configs_state_only_what_runs(name):
    import importlib

    from gnnbench import reference

    cfg = catalog.config(catalog.workload(name)["config"])
    ref = importlib.import_module(f"gnnbench.reference.{cfg['arch']}")
    reference.refuse_unbuilt(cfg, ref.READS, ref.FIXED)


def test_traffic_states_only_what_the_generator_reads(tmp_path):
    from gnnbench import traffic

    (tmp_path / "traffic").mkdir()
    d = json.loads((traffic.HERE / "traffic" / "arxiv-full.json").read_text())
    (tmp_path / "traffic" / "t.json").write_text(json.dumps(d))
    assert traffic.load("t", tmp_path).n_edge == 2_501_829
    (tmp_path / "traffic" / "t.json").write_text(json.dumps(dict(d, power=1.2)))
    with pytest.raises(ValueError, match="power"):
        traffic.load("t", tmp_path)
