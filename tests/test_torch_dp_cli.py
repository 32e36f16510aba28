"""The CLI's ``--n_devices 2`` branch against the JAX CLI's, on the CPU.

The port's CLI starts two ranks of itself over gloo (``launch_local``) and returns
rank 0's result; the JAX CLI runs its data-parallel branch on 2 devices of the
virtual mesh. The JAX CLI trains 2 epochs and saves; its parameters are carried into
a port checkpoint (``params_from_flax``) and both CLIs ``--resume`` from them
(``resumed_from`` 2 in both). On the host path (GraphSAGE synchronous, with
``--async_dp`` and with ``--cached_nPercent 25``; GCN with ``--n_parts 2``; GIN;
GAT) both then train one more epoch at dropout 0 on the same sampled blocks: test
accuracy and micro-F1 equal, the saved parameters within 1e-5 (float32, Adam), the
cache's counters equal (each rank's cache counts its sub-batches, summed over the
ranks; evaluation counted once, as the JAX controller's single cache counts it). On
the device-sampling path (neighbour and FastGCN) the two packages cannot draw the
same uniforms through the CLI, so both resume with no epoch and ``--exact_eval``:
test accuracy equal (the epoch itself is held to JAX's in
``test_torch_dp_epoch.py``). ``--samp_type full --n_devices 2`` trains on one device
in both. Both CLIs refuse the same configurations with ``ValueError``, the port
before it starts a rank, and raise a rank's ``ValueError`` (too few train seeds for
a step) as the JAX CLI does; ``--n_parts 2`` with a layer-wise sampler is refused by
both, before COG. Each run of ranks has a time limit (``main(..., timeout=)``).
"""
import jax
import numpy as np
import pytest

from dgll_tpu.run import main as jax_main
from dgll_tpu.train import CheckpointManager as JaxCheckpointManager
from dgll_tpu_torch import run as torch_run
from dgll_tpu_torch.nn import params_from_flax
from dgll_tpu_torch.train import CheckpointManager

CLI = ["--n_node", "2000", "--nhid", "16", "--feat_dim", "8", "--batch_size", "128"]
LIMIT_S = 180  # the ranks' time limit in each port run


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # each rank's intra-op threads


def port_main(args):
    return torch_run.main(args + ["--device", "cpu"], timeout=LIMIT_S)


def _jax_params(directory):
    mgr = JaxCheckpointManager(directory)
    step = mgr.latest_step()
    params = mgr.restore(None, step)
    mgr.close()
    return step, params_from_flax(jax.tree.map(np.asarray, params))


def _resume_both(tmp_path, args, epochs):
    """Train the JAX CLI 2 epochs, then resume both CLIs from its parameters for
    ``epochs`` more at dropout 0: ``(jax trial, port trial, jax params, port params)``."""
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_main(args + ["--n_epochs", "2", "--checkpoint_dir", dj])
    step, params = _jax_params(dj)
    CheckpointManager(dt).save(step, params)
    resume = ["--n_epochs", str(epochs), "--dropout", "0", "--resume"]
    want = jax_main(args + resume + ["--checkpoint_dir", dj])["trials"][0]
    got = port_main(args + resume + ["--checkpoint_dir", dt])["trials"][0]
    _, want_p = _jax_params(dj)
    return want, got, want_p, CheckpointManager(dt).restore(want_p)


def _same_result(want, got):
    assert set(got) == set(want) | {"epoch_loss", "epoch_s"}
    assert got["resumed_from"] == want["resumed_from"] == 2
    for k in ("test_acc", "micro_f1", "metric", "epochs"):
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=0), k


@pytest.mark.parametrize("args", [
    ["--Model", "GraphSAGE"],
    ["--Model", "GraphSAGE", "--async_dp"],
    ["--Model", "GCN", "--n_parts", "2"],
    ["--Model", "GraphSAGE", "--cached_nPercent", "25"],
    ["--Model", "GIN"],
    ["--Model", "GAT", "--n_heads", "2", "--nhid", "8"],
], ids=["sync", "async", "n_parts", "cache", "gin", "gat"])
def test_host_dp_resumes_and_trains_as_the_jax_cli(tmp_path, args):
    args = CLI + ["--n_devices", "2"] + args
    want, got, want_p, got_p = _resume_both(tmp_path, args, epochs=1)
    _same_result(want, got)
    assert got["n_devices"] == want["n_devices"] == 2
    assert got["async_dp"] == want["async_dp"] == ("--async_dp" in args)
    for k in ("cache_lookups", "cached_rows", "n_communities"):
        assert got.get(k) == want.get(k), k
    if "cache_miss_rate" in want:
        assert got["cache_miss_rate"] == pytest.approx(want["cache_miss_rate"], rel=1e-12)
    for k, v in want_p.items():
        np.testing.assert_allclose(got_p[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("args", [
    ["--Model", "GraphSAGE", "--device_sampling"],
    ["--Model", "GCN", "--samp_type", "fastgcn", "--device_sampling", "--n_samp", "128"],
], ids=["neighbor", "fastgcn"])
def test_device_dp_resumes_as_the_jax_cli(tmp_path, args):
    args = CLI + ["--n_devices", "2", "--exact_eval"] + args
    want, got, want_p, got_p = _resume_both(tmp_path, args, epochs=0)
    _same_result(want, got)
    for k in ("n_devices", "async_dp", "device_sampling", "window_sampling", "exact_eval"):
        assert got[k] == want[k], k
    for k, v in want_p.items():  # saved again, untouched
        np.testing.assert_array_equal(got_p[k].numpy(), v.numpy(), err_msg=k)


def test_full_batch_with_two_devices_trains_on_one(tmp_path):
    args = CLI + ["--samp_type", "full", "--n_devices", "2"]
    want, got, _, _ = _resume_both(tmp_path, args, epochs=0)
    _same_result(want, got)
    assert "n_devices" not in got and "n_devices" not in want


@pytest.mark.parametrize("args,match", [
    (["--samp_type", "fastgcn"], "--n_devices > 1 requires"),
    (["--samp_type", "ladies", "--Model", "GAT"], "--n_devices > 1 requires"),
    (["--device_sampling", "--cached_nPercent", "25"], "--cached_nPercent"),
    (["--device_sampling", "--n_parts", "2"], "--n_parts"),
    (["--n_node", "600", "--batch_size", "128"], "train seeds"),
], ids=["fastgcn-host", "ladies-host", "device-cache", "device-n_parts", "few-seeds"])
def test_both_clis_refuse(args, match):
    args = ["--n_node", "2000", "--n_epochs", "1", "--nhid", "8", "--n_devices", "2", *args]
    with pytest.raises(ValueError, match=match):
        jax_main(args)
    with pytest.raises(ValueError, match=match):
        port_main(args)


@pytest.mark.parametrize("sampler", ["fastgcn", "ladies"])
@pytest.mark.parametrize("model", ["GCN", "GraphSAGE"])
def test_n_parts_needs_the_neighbour_sampler_in_both_clis(sampler, model):
    args = ["--Model", model, "--samp_type", sampler, "--n_parts", "2", "--n_node", "600",
            "--n_epochs", "1", "--n_samp", "128"]
    with pytest.raises(ValueError, match="--n_parts > 1 requires --samp_type neighbor"):
        jax_main(args)
    with pytest.raises(ValueError, match="--n_parts > 1 requires --samp_type neighbor"):
        torch_run.main(args + ["--device", "cpu"])
