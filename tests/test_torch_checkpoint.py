"""The port's checkpoints, ``--checkpoint_dir``/``--resume`` on every single-device
branch of the CLI, and ``device_trace``, on the CPU.

``CheckpointManager`` round-trips a ``state_dict`` (onto the template's device and
type), keeps the newest 3 steps and returns None from an empty directory. The CLI
saves at step ``epochs + resumed_from`` and, with ``--resume``, starts from the
latest step, reporting it as ``resumed_from`` as the JAX CLI does (whose
checkpoints are orbax directories the port does not read: the two CLIs each resume
their own). ``device_trace`` writes a Chrome trace of what ran inside it.

The CLI's numbers against the JAX CLI's: the JAX CLI trains and saves, its
parameters are carried into a port checkpoint through ``params_from_flax``, and both
CLIs resume them. With no epoch they report the same test accuracy and micro-F1:
equal in float32, within 0.01 under bfloat16 (a test node whose top two
log-probabilities lie within bf16 rounding may flip). With one more epoch at
dropout 0 (float32: full-batch Adam is deterministic) they save the same parameters
within 1e-5, the full-batch trainer's bar. Under bfloat16 that second check does not
hold: Adam's first step moves a parameter by about ``lr`` times the sign of its
gradient, and a gradient within bf16 rounding of 0 takes either sign.
"""
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from dgll_tpu.run import main as jax_main
from dgll_tpu.train import CheckpointManager as JaxCheckpointManager
from dgll_tpu_torch.data import save_graph, synthetic_classification_graph
from dgll_tpu_torch import run as torch_run
from dgll_tpu_torch.nn import GAT, GCN, params_from_flax
from dgll_tpu_torch.train import CheckpointManager
from dgll_tpu_torch.utils import device_trace, parse_train_config


def _state(seed):
    return GCN(6, 8, 3, generator=torch.Generator().manual_seed(seed)).state_dict()


def test_round_trip_onto_the_template(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() is None and mgr.restore(_state(0)) is None
    saved = _state(1)
    mgr.save(7, saved, wait=True)
    template = {k: v.to(torch.bfloat16) for k, v in _state(2).items()}
    got = mgr.restore(template)
    assert mgr.latest_step() == 7 and set(got) == set(saved)
    for k, v in got.items():
        assert v.dtype == torch.bfloat16
        assert torch.equal(v, saved[k].to(torch.bfloat16))
    assert all(torch.equal(a, b) for a, b in zip(mgr.restore(_state(3), step=7).values(),
                                                 saved.values()))
    mgr.close()


def test_keeps_the_newest_three(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    for step in (1, 5, 2, 9, 4):
        mgr.save(step, _state(step))
    assert mgr.steps() == [4, 5, 9] and mgr.latest_step() == 9
    assert sorted(os.listdir(tmp_path)) == ["step_4.pt", "step_5.pt", "step_9.pt"]
    got = mgr.restore(_state(0), step=5)
    assert all(torch.equal(got[k], v) for k, v in _state(5).items())
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), max_to_keep=0)


def test_restore_refuses_another_model(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(0))
    with pytest.raises(ValueError, match="template"):
        mgr.restore(GAT(6, 4, 3, num_heads=2).state_dict())
    with pytest.raises(ValueError, match="need"):
        mgr.restore(GCN(7, 8, 3).state_dict())


def test_maybe_restore_loads_the_latest_step(tmp_path):
    ck = str(tmp_path / "ck")
    CheckpointManager(ck).save(4, _state(1))
    model = GCN(6, 8, 3, generator=torch.Generator().manual_seed(2))
    extra = {}
    torch_run.maybe_restore(parse_train_config(["--checkpoint_dir", ck]), model, extra)
    assert extra == {}   # without --resume nothing is loaded
    assert all(torch.equal(model.state_dict()[k], v) for k, v in _state(2).items())
    torch_run.maybe_restore(parse_train_config(["--checkpoint_dir", ck, "--resume"]),
                            model, extra)
    assert extra == {"resumed_from": 4}
    assert all(torch.equal(model.state_dict()[k], v) for k, v in _state(1).items())
    empty = {}
    torch_run.maybe_restore(parse_train_config(["--checkpoint_dir", str(tmp_path / "e"),
                                                "--resume"]), model, empty)
    assert empty == {}


BASE = ["--device", "cpu", "--n_node", "400", "--nhid", "8", "--feat_dim", "8",
        "--batch_size", "64", "--n_samp", "64"]


@pytest.mark.parametrize("branch", [
    ["--samp_type", "full"],
    ["--samp_type", "full", "--Model", "GAT", "--n_heads", "2", "--dtype", "bfloat16"],
    ["--samp_type", "neighbor", "--Model", "GraphSAGE"],
    ["--samp_type", "neighbor", "--Model", "GraphSAGE", "--preprocess"],
    ["--samp_type", "neighbor", "--device_sampling"],
    ["--samp_type", "fastgcn"],
    ["--samp_type", "ladies", "--device_sampling", "--Model", "GIN"],
])
def test_cli_saves_and_resumes_on_each_branch(tmp_path, branch):
    ck = str(tmp_path / "ck")
    first = torch_run.main(BASE + branch + ["--n_epochs", "2", "--checkpoint_dir", ck])
    assert "resumed_from" not in first["trials"][0]
    mgr = CheckpointManager(ck)
    assert mgr.steps() == [2]
    saved = torch.load(os.path.join(ck, "step_2.pt"), weights_only=True)
    # the resumed run starts from the saved parameters: with no epoch it saves them
    # again unchanged, at the same step
    out = torch_run.main(BASE + branch + ["--n_epochs", "0", "--checkpoint_dir", ck,
                                          "--resume"])
    assert out["trials"][0]["resumed_from"] == 2 and mgr.steps() == [2]
    again = torch.load(os.path.join(ck, "step_2.pt"), weights_only=True)
    assert set(again) == set(saved)
    assert all(torch.equal(again[k], saved[k]) for k in saved)
    out = torch_run.main(BASE + branch + ["--n_epochs", "1", "--checkpoint_dir", ck,
                                          "--resume"])
    trial = out["trials"][0]
    assert trial["resumed_from"] == 2 and trial["epochs"] == 1
    assert mgr.steps() == [2, 3]


def test_cli_resume_keys_match_the_jax_cli(tmp_path):
    args = ["--samp_type", "full", "--n_node", "300", "--nhid", "8", "--n_epochs", "1"]
    for who, run in (("jax", jax_main),
                     ("port", lambda a: torch_run.main(a + ["--device", "cpu"]))):
        ck = str(tmp_path / who)
        first = run(args + ["--checkpoint_dir", ck])
        second = run(args + ["--checkpoint_dir", ck, "--resume"])
        keys = (set(first["trials"][0]), set(second["trials"][0]))
        if who == "jax":
            want = keys
        assert second["trials"][0]["resumed_from"] == 1
    assert keys[0] == want[0] | {"epoch_loss", "epoch_s"}
    assert keys[1] == want[1] | {"epoch_loss", "epoch_s"}
    assert "resumed_from" in keys[1] and "resumed_from" not in keys[0]


def _jax_params(directory):
    mgr = JaxCheckpointManager(directory)
    step = mgr.latest_step()
    params = mgr.restore(None, step)
    mgr.close()
    return step, params_from_flax(jax.tree.map(np.asarray, params))


PLANETOID = os.path.join(os.path.dirname(__file__), "fixtures", "planetoid", "tiny")
GAT_CLI = ["--Model", "GAT", "--nhid", "8", "--n_heads", "8", "--lr", "0.005"]
BF16 = ["--dtype", "bfloat16"]


@pytest.mark.parametrize("args,tol,one_epoch", [
    (GAT_CLI + ["--samp_type", "full", "--n_node", "1000"] + BF16, 0.01, False),
    (GAT_CLI + ["--samp_type", "full", "--n_node", "1000"], 0.0, True),
    (GAT_CLI + ["--samp_type", "full", "--dataset", "saved"] + BF16, 0.01, False),
    (["--Model", "GCN", "--samp_type", "full", "--dataset", "saved", "--nhid", "8"],
     0.0, True),
    (["--Model", "GCN", "--samp_type", "full", "--dataset", PLANETOID, "--nhid", "8"],
     0.0, True),
    (["--Model", "GraphSAGE", "--samp_type", "neighbor", "--exact_eval", "--n_node",
      "1000", "--nhid", "8", "--batch_size", "128"] + BF16, 0.01, False),
    (["--Model", "GIN", "--samp_type", "neighbor", "--device_sampling", "--exact_eval",
      "--n_node", "1000", "--nhid", "8", "--batch_size", "128"] + BF16, 0.01, False),
], ids=["gat-bf16", "gat-f32", "gat-bf16-saved-graph", "gcn-saved-graph",
        "gcn-planetoid", "sage-bf16-exact-eval", "gin-bf16-device-exact-eval"])
def test_cli_on_jax_parameters_matches_the_jax_cli(tmp_path, args, tol, one_epoch):
    if "saved" in args:
        path = str(tmp_path / "g.graph")
        save_graph(synthetic_classification_graph(n_node=400, avg_degree=4, n_class=3,
                                                  feat_dim=8, seed=5), path)
        args = [path if a == "saved" else a for a in args]
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_main(args + ["--n_epochs", "2", "--checkpoint_dir", dj])
    step, params = _jax_params(dj)
    CheckpointManager(dt).save(step, params)
    resume = ["--n_epochs", "0", "--resume"]
    want = jax_main(args + resume + ["--checkpoint_dir", dj])["trials"][0]
    got = torch_run.main(args + resume + ["--checkpoint_dir", dt, "--device", "cpu"])
    got = got["trials"][0]
    assert got["resumed_from"] == want["resumed_from"] == 2
    for k in ("test_acc", "micro_f1", "metric"):
        if math.isnan(want[k]):   # no test node (the planetoid fixture)
            assert math.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
    if one_epoch:
        resume = ["--n_epochs", "1", "--dropout", "0", "--resume"]
        jax_main(args + resume + ["--checkpoint_dir", dj])
        torch_run.main(args + resume + ["--checkpoint_dir", dt, "--device", "cpu"])
        step, want_p = _jax_params(dj)
        got_p = CheckpointManager(dt).restore(want_p)
        assert step == 3 == CheckpointManager(dt).latest_step()
        for k, v in want_p.items():
            np.testing.assert_allclose(got_p[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    x = torch.randn(64, 64)
    with device_trace(str(log_dir)) as prof:
        (x @ x).sum()
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.loads((log_dir / files[0]).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())
