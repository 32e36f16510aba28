"""The port's examples (``dgll_tpu_torch/examples``) at a tiny size on the CPU.

The three that are the training CLI with fixed flags print the JAX CLI's keys for
the same flags; the others train a few epochs and report finite numbers (the
multi-rank one in two ranks over gloo; DeepWalk its five classifiers' accuracies).
Each runs as ``python -m dgll_tpu_torch.examples.<name>`` too (one is run that way
here).
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dgll_tpu.run import main as jax_main
from dgll_tpu_torch.examples import (
    deepwalk_embedding,
    device_fastgcn_gcn,
    device_pipeline_sage,
    full_batch_gcn,
    graph_classification_gin,
    layerwise_fastgcn,
    minibatch_graphsage,
    multichip_training,
    ppi_eval,
)

REPO = Path(__file__).resolve().parents[1]
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
SMALL = ["--n_node", "600", "--n_epochs", "2", "--nhid", "8", "--batch_size", "64"]


@pytest.mark.parametrize("example, fixed", [
    (full_batch_gcn, ["--Model", "GCN", "--samp_type", "full"]),
    (minibatch_graphsage, ["--Model", "GraphSAGE", "--samp_type", "neighbor"]),
    (layerwise_fastgcn, ["--Model", "GCN", "--samp_type", "fastgcn"]),
])
def test_cli_examples_print_the_jax_cli_keys(example, fixed):
    got = example.main(SMALL + ["--n_samp", "64", "--device", "cpu"])
    want = jax_main(fixed + SMALL + ["--n_samp", "64"])
    assert got["config"]["model"] == fixed[1]
    assert got["config"]["sampler"] == fixed[3]
    assert set(got["trials"][0]) == set(want["trials"][0]) | {"epoch_loss", "epoch_s"}
    assert np.isfinite(got["trials"][0]["epoch_loss"]).all()


def test_layerwise_example_takes_the_sampler_given():
    got = layerwise_fastgcn.main(SMALL + ["--samp_type", "ladies", "--n_samp", "64",
                                          "--device", "cpu"])
    assert got["config"]["sampler"] == "ladies"


def test_device_examples_train():
    out = device_pipeline_sage.main(["--device", "cpu", "--n_node", "1500", "--epochs", "2",
                                     "--batch_size", "64"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert 0 <= out["test_acc"] <= 1
    out = device_fastgcn_gcn.main(["--device", "cpu", "--n_node", "1500", "--epochs", "2",
                                   "--layer_sizes", "128,64", "--batch_size", "64"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()


def test_graph_classification_example(tmp_path):
    out = graph_classification_gin.main(["--device", "cpu", "--epochs", "3",
                                         "--n_graph", "24", "--fold_idx", "1"])
    assert out["fold"] == 1 and out["n_train"] + out["n_test"] == 24
    assert np.isfinite(out["loss"]) and 0 <= out["test_acc"] <= 1
    path = tmp_path / "graphs.txt"
    rows = ["12"] + sum(([f"3 {i % 2}", "0 2 1 2", "1 1 0", "0 1 0"] for i in range(12)),
                        [])
    path.write_text("\n".join(rows) + "\n")
    out = graph_classification_gin.main(["--device", "cpu", "--epochs", "2",
                                         "--data", str(path), "--degree_as_tag"])
    assert out["n_train"] + out["n_test"] == 12 and np.isfinite(out["loss"])


def test_ppi_example_on_synthetic_and_fixture_data(tmp_path):
    out = ppi_eval.main(["--device", "cpu", "--epochs", "2", "--hidden", "16",
                         "--n_node", "120"])
    assert np.isfinite(out["loss"]) and 0 <= out["test_micro_f1"] <= 1
    # the fixture holds a train split only: it serves as the test split too
    for f in (Path(FIX) / "ppi").iterdir():
        for split in ("train", "test"):
            shutil.copy(f, tmp_path / f.name.replace("train", split))
    out = ppi_eval.main(["--device", "cpu", "--epochs", "2", "--hidden", "16",
                         "--data", str(tmp_path)])
    assert np.isfinite(out["loss"]) and 0 <= out["test_micro_f1"] <= 1


def test_examples_run_as_modules():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "dgll_tpu_torch.examples.full_batch_gcn", "--device", "cpu",
         *SMALL], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert '"trials"' in proc.stdout


def test_multichip_example_trains_in_two_ranks(monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = multichip_training.main(["--device", "cpu", "--epochs", "2"])
    assert out["ranks"] == 2 and out["backend"] == "gloo"
    assert len(out["dp_loss"]) == 2 and np.isfinite(out["dp_loss"]).all()
    assert out["dp_loss"][1] < out["dp_loss"][0]
    assert np.isfinite(out["gp_loss"])
    assert "gp loss after 10 steps" in capsys.readouterr().out


@pytest.mark.parametrize("kind", ["deepwalk", "node2vec"])
def test_deepwalk_example(kind, capsys):
    out = deepwalk_embedding.main([kind, "--device", "cpu", "--n_node", "120",
                                   "--epochs", "1"])
    assert out["kind"] == kind and out["finite"]
    assert sorted(out["accuracy"]) == ["boosting", "forest", "logistic", "mlp", "tree"]
    assert all(0 <= a <= 1 for a in out["accuracy"].values())
    assert "'logistic'" in capsys.readouterr().out
