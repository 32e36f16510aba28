"""The flagship path's surfaces against the JAX package's: the CLI's device-sampling
and exact-eval branches and GAT on sampled blocks, the headline bench, and
``entry()``.

The CLI and the bench print the JAX package's JSON keys (the port adds ``device``
to the config, and ``epoch_loss``/``epoch_s`` to a trial; the bench's ``detail``
adds ``cuda_graph`` and ``adam``). ``entry()`` samples the JAX hook's blocks, equal
field for field, and its forward matches the JAX model's within 1e-5 (float32) from
the same parameters.
"""
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest

from dgll_tpu.run import main as jax_main
from dgll_tpu_torch import run as torch_run
from dgll_tpu_torch.entry import entry
from dgll_tpu_torch.nn import params_from_flax
from test_torch_edge_ops import _thread_pool  # noqa: F401 (fixture)

REPO = Path(__file__).resolve().parents[1]
CLI = ["--n_node", "600", "--n_epochs", "3", "--batch_size", "64", "--nhid", "16",
       "--feat_dim", "16", "--n_stops", "0"]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("args", [
    ["--Model", "GraphSAGE", "--device_sampling"],
    ["--Model", "GraphSAGE", "--device_sampling", "--window_sampling", "--exact_eval"],
    ["--Model", "GCN", "--device_sampling", "--exact_eval"],
    ["--Model", "GAT", "--device_sampling", "--nhid", "4", "--n_heads", "2"],
    ["--Model", "GAT", "--samp_type", "neighbor", "--nhid", "4", "--n_heads", "2"],
    ["--Model", "GCN", "--samp_type", "neighbor", "--exact_eval"],
])
def test_cli_minibatch_branches_print_the_jax_cli_keys(args):
    want = jax_main(CLI + args)
    got = torch_run.main(CLI + args + ["--device", "cpu"])
    assert set(got) == set(want) == {"config", "trials", "aggregate"}
    # the port's flags: --device, and GCNII's --alpha and --lamda
    assert set(got["config"]) == set(want["config"]) | {"device", "alpha", "lamda"}
    assert set(got["trials"][0]) == set(want["trials"][0]) | {"epoch_loss", "epoch_s"}
    assert set(got["aggregate"]) == set(want["aggregate"])
    trial = got["trials"][0]
    losses = trial["epoch_loss"]
    assert trial["epochs"] == 3 and len(losses) == len(trial["epoch_s"]) == 3
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert 0 <= trial["test_acc"] <= 1
    for key in ("device_sampling", "window_sampling", "exact_eval"):
        if key in want["trials"][0]:
            assert trial[key] == want["trials"][0][key] == (f"--{key}" in args), key


@pytest.mark.parametrize("args, error, match", [
    (["--device_sampling", "--cached_nPercent", "25"], ValueError, "--cached_nPercent"),
    (["--device_sampling", "--n_parts", "2"], ValueError, "--n_parts"),
])
def test_cli_device_sampling_refuses(args, error, match):
    with pytest.raises(error, match=match):
        torch_run.main(CLI + args + ["--device", "cpu"])
    if error is ValueError:  # the JAX CLI refuses the same
        with pytest.raises(ValueError):
            jax_main(CLI + args)


def test_bench_prints_the_jax_bench_keys(monkeypatch, capsys):
    monkeypatch.setenv("BENCH_NODES", "3000")
    monkeypatch.setenv("BENCH_FULLGRAPH", "0")   # the JAX one's needs the TPU kernels
    _load("jax_bench", REPO / "bench.py").main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    from dgll_tpu_torch import bench

    monkeypatch.setenv("BENCH_FULLGRAPH", "1")
    monkeypatch.setenv("BENCH_FG_NODES", "4096")
    got = bench.main(["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(got))
    assert set(got) == set(want)
    assert set(got["detail"]) == set(want["detail"]) | {"fullgraph_gcn_pallas",
                                                        "cuda_graph", "adam"}
    assert got["metric"] == "sage_batch_time_incl_sampling" and got["unit"] == "ms"
    for k in ("includes_sampling", "sampling", "n_batches_per_epoch", "n_node", "avg_deg",
              "batch", "fanouts", "feat_dim", "hidden"):
        assert got["detail"][k] == want["detail"][k], k
    assert got["value"] > 0 and got["vs_baseline"] == pytest.approx(6.12 / got["value"])
    assert got["detail"]["step_only_ms"] > 0 and not got["detail"]["cuda_graph"]
    assert got["detail"]["fullgraph_gcn_pallas"]["steps"] == 14


def test_bench_graph_is_the_jax_benchs():
    from dgll_tpu_torch.bench import power_law_graph

    jb = _load("jax_bench", REPO / "bench.py")
    for a, b in zip(power_law_graph(5000, 7), jb._power_law_graph(5000, 7)):
        np.testing.assert_array_equal(a, b)


def test_entry_matches_the_jax_hook():
    ge = _load("jax_entry", REPO / "__graft_entry__.py")
    fj, (params, bj, xj) = ge.entry()
    ft, (model, bt, xt) = entry("cpu")
    assert len(bt) == len(bj) == 2
    for t, j in zip(bt, bj):
        assert (t.fanout, t.n_dst) == (j.fanout, j.n_dst)
        for name in ("dst_ids", "src_ids", "neigh_mask", "dst_mask"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)), err_msg=name)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    out = ft(model, bt, xt)
    assert out.shape == (64, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(fj(params, bj, xj)), rtol=1e-5,
                               atol=1e-5)
