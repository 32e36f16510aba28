"""Parity of the port's ``PipelinedTrainer`` (``MQTrainer``) and the CLI's
``--preprocess`` with the JAX package's.

Both trainers start from the JAX model's initial parameters (``params_from_flax``)
and sample the same batches (the same C++ sampler and seed stream); with dropout 0
their per-epoch losses agree within 1e-4 (float32, Adam), as in
``test_torch_minibatch.py``, and the cache's counters exactly. The preprocessed
features agree with the JAX CLI's within 1e-6 (float32 sums in another order).
"""
import functools

import jax
import numpy as np
import optax
import pytest
import torch

from dgll_tpu.cache import HBMFeatureCache as JaxCache
from dgll_tpu.data import gcn_normalize as jax_gcn_normalize
from dgll_tpu.data import synthetic_classification_graph as jax_synthetic
from dgll_tpu.nn import GraphSAGE as JaxGraphSAGE
from dgll_tpu.run import _prepare_pipeline as jax_prepare_pipeline
from dgll_tpu.run import build_dataset as jax_build_dataset
from dgll_tpu.run import build_model as jax_build_model
from dgll_tpu.run import main as jax_main
from dgll_tpu.sampling import NeighborSampler as JaxSampler
from dgll_tpu.train import PipelinedTrainer as JaxPipelinedTrainer
from dgll_tpu.utils import PhaseTimer as JaxPhaseTimer
from dgll_tpu.utils import parse_train_config as jax_parse_train_config
from dgll_tpu_torch import run as torch_run
from dgll_tpu_torch.cache import HBMFeatureCache
from dgll_tpu_torch.data import gcn_normalize, synthetic_classification_graph
from dgll_tpu_torch.nn import GraphSAGE, params_from_flax
from dgll_tpu_torch.sampling import NeighborSampler
from dgll_tpu_torch.train import MQTrainer, PipelinedTrainer
from dgll_tpu_torch.utils import PhaseTimer, get_logger, parse_train_config
from test_torch_edge_ops import _thread_pool  # noqa: F401 (fixture)

GRAPH = dict(n_node=400, avg_degree=8, n_class=4, feat_dim=16, seed=0)
ADAM = (optax.adam(1e-2), functools.partial(torch.optim.Adam, lr=1e-2))


@pytest.fixture(scope="module")
def graphs():
    return (gcn_normalize(synthetic_classification_graph(**GRAPH)),
            jax_gcn_normalize(jax_synthetic(**GRAPH)))


def _half_cache(g, cls, **kw):
    """A cache of half the nodes' rows, by in-degree (the JAX test's policy)."""
    feats = np.asarray(g.node_feat) if cls is JaxCache else g.node_feat.numpy()
    cache = cls(feats, **kw)
    deg = np.asarray(g.in_degrees) if cls is JaxCache else np.diff(g.indptr.numpy())
    cache.auto_cache(deg, budget_bytes=deg.shape[0] * 16 * 4 // 2)
    return cache


def _pair(graphs, hidden=16, fanouts=(4, 3), cached=False, seed=0):
    """The JAX trainer, initialised, and the port's from the same parameters."""
    gt, gj = graphs
    jt = JaxPipelinedTrainer(
        JaxGraphSAGE(hidden=hidden, n_class=4, dropout=0.0), ADAM[0], gj,
        JaxSampler(list(fanouts), seed=0), batch_size=32,
        features=_half_cache(gj, JaxCache) if cached else gj.node_feat,
        labels=gj.labels, seed=seed).init(gj.get_train_nodes())
    model = GraphSAGE(16, hidden, 4, dropout=0.0)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, jt.state.params)))
    tt = PipelinedTrainer(
        model, ADAM[1], gt, NeighborSampler(list(fanouts), seed=0), batch_size=32,
        features=_half_cache(gt, HBMFeatureCache, device="cpu") if cached else gt.node_feat,
        labels=gt.labels, seed=seed, device="cpu").init(gt.get_train_nodes())
    return jt, tt


@pytest.mark.parametrize("cached", [False, True])
def test_epoch_losses_match_jax(graphs, cached):
    gt, _ = graphs
    jt, tt = _pair(graphs, cached=cached)
    train, val = gt.get_train_nodes(), gt.get_validation_nodes()
    want = jt.fit(train, val, epochs=3)
    got = tt.fit(train, val, epochs=3)
    assert set(got) == set(want)
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in want["history"]], rtol=1e-4, atol=1e-4)
    assert [h["epoch"] for h in got["history"]] == [0, 1, 2]
    assert abs(got["best_val"] - want["best_val"]) <= 1 / len(val)  # argmax near a tie
    assert {"load", "compute"} == set(got["phases"]) == set(want["phases"])
    if cached:
        assert tt.cache.miss_rate() == jt.cache.miss_rate()
        assert got["cache_miss_rate"] == want["cache_miss_rate"]
        assert 0.0 < got["cache_miss_rate"] < 0.9  # a hot-degree cache beats random
    else:
        assert "cache_miss_rate" not in got


def test_pipelined_trainer_learns(graphs):
    gt, _ = graphs
    model = GraphSAGE(16, 32, 4, dropout=0.0, generator=torch.Generator().manual_seed(0))
    tr = MQTrainer(model, ADAM[1], gt, NeighborSampler([5, 5], seed=0), batch_size=32,
                   features=gt.node_feat, labels=gt.labels, seed=0, device="cpu")
    assert MQTrainer is PipelinedTrainer
    with pytest.raises(RuntimeError, match="init"):
        tr.train_epoch(gt.get_train_nodes())
    tr.init(gt.get_train_nodes())
    res = tr.fit(np.arange(gt.n_real_node), gt.get_validation_nodes(), epochs=5)
    assert res["best_val"] > 0.7, res["best_val"]
    assert res["phases"]["load"] > 0 and res["phases"]["compute"] > 0
    assert res["total_s"] >= sum(h["s"] for h in res["history"])
    assert tr.evaluate_nodes(gt.get_test_nodes()) > 0.7


def test_early_stopping(graphs):
    gt, _ = graphs
    model = GraphSAGE(16, 8, 4, dropout=0.0, generator=torch.Generator().manual_seed(0))
    tr = PipelinedTrainer(model, functools.partial(torch.optim.Adam, lr=1e-4), gt,
                          NeighborSampler([3, 3], seed=0), batch_size=32,
                          features=gt.node_feat, labels=gt.labels, device="cpu")
    res = tr.init(gt.get_train_nodes()).fit(gt.get_train_nodes(),
                                            gt.get_validation_nodes(), epochs=50,
                                            patience=2)
    assert 2 < len(res["history"]) < 50


# -------------------------------------------------------------- --preprocess

CLI = ["--samp_type", "neighbor", "--n_node", "600", "--n_epochs", "3",
       "--batch_size", "64", "--nhid", "16", "--feat_dim", "16", "--preprocess"]


def test_preprocess_widens_the_features_and_cuts_a_hop_as_jax():
    cfg_t = parse_train_config(CLI + ["--Model", "GraphSAGE", "--device", "cpu"])
    cfg_j = jax_parse_train_config(CLI + ["--Model", "GraphSAGE"])
    g_t, g_j = torch_run.build_dataset(cfg_t), jax_build_dataset(cfg_j)
    extra_t, extra_j = {}, {}
    model = torch_run.build_model(cfg_t, 16, 16)
    cfg2, g2, model2, _, _, _ = torch_run.prepare_pipeline(
        cfg_t, g_t, model, 16, 0, PhaseTimer(), extra_t, torch.device("cpu"), get_logger())
    cfg2_j, g2_j, _, _, _, _ = jax_prepare_pipeline(
        cfg_j, g_j, jax_build_model(cfg_j, 16), 16, JaxPhaseTimer(), extra_j, get_logger())
    assert extra_t == extra_j == {"preprocess": True}
    assert cfg2.fanouts == cfg2_j.fanouts == [5] and cfg2.n_layers == cfg2_j.n_layers == 1
    assert g2.node_feat.shape == (600, 32)
    np.testing.assert_allclose(g2.node_feat.numpy(), np.asarray(g2_j.node_feat),
                               rtol=1e-6, atol=1e-6)
    assert model2.convs[0].self.in_features == 32 and len(model2.convs) == 1
    assert g_t.node_feat.shape == (600, 16)  # the caller's graph is left as it was


@pytest.mark.parametrize("args", [
    ["--Model", "GraphSAGE"],
    ["--Model", "GCN", "--cached_nPercent", "25"],
    ["--Model", "GraphSAGE", "--device_sampling"],
])
def test_cli_preprocess_prints_the_jax_cli_keys(args):
    want = jax_main(CLI + args)
    got = torch_run.main(CLI + args + ["--device", "cpu"])
    assert set(got) == set(want) == {"config", "trials", "aggregate"}
    assert set(got["trials"][0]) == set(want["trials"][0]) | {"epoch_loss", "epoch_s"}
    trial = got["trials"][0]
    assert trial["preprocess"] is True and want["trials"][0]["preprocess"] is True
    assert got["config"]["preprocess"] and got["config"]["fanouts"] == [10, 5]
    losses = trial["epoch_loss"]
    assert trial["epochs"] == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert trial["test_acc"] > 1 / 16
    if "--device_sampling" in args:
        assert trial["device_sampling"] is True
