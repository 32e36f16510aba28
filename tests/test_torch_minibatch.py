"""Parity of the port's host minibatch path with the JAX package's: the block
aggregations, ``SAGEConv``, ``GraphSAGE`` and ``GCN`` on sampled blocks,
``MiniBatchTrainer`` with and without the feature cache, and the CLI's host branch.

Both sides sample the same blocks (``test_torch_sampling.py``) from the same graph
and start from the same parameters (``params_from_flax``). Tolerances: 1e-6 for the
aggregations, 1e-5 for the layers' and models' outputs and gradients (float32, the
order of the sums), 1e-4 for the per-epoch losses of training, with dropout 0; the
f32 cache that holds every row gives the plain gather's losses within 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dgll_tpu.cache import HBMFeatureCache as JaxCache
from dgll_tpu.data import gcn_normalize as jax_gcn_normalize
from dgll_tpu.data import synthetic_classification_graph as jax_synthetic
from dgll_tpu.dataloader import DataLoader as JaxDataLoader
from dgll_tpu.nn import GCN as JaxGCN
from dgll_tpu.nn import GraphSAGE as JaxGraphSAGE
from dgll_tpu.nn.conv import SAGEConv as JaxSAGEConv
from dgll_tpu.ops import spmm as jax_spmm
from dgll_tpu.run import main as jax_main
from dgll_tpu.sampling import HostGraph as JaxHostGraph
from dgll_tpu.sampling import NeighborSampler as JaxSampler
from dgll_tpu.train import MiniBatchTrainer as JaxTrainer
from dgll_tpu.train.trainer import TrainState as JaxTrainState
from dgll_tpu_torch import run as torch_run
from dgll_tpu_torch.cache import HBMFeatureCache
from dgll_tpu_torch.data import gcn_normalize, synthetic_classification_graph
from dgll_tpu_torch.dataloader import DataLoader
from dgll_tpu_torch.nn import GCN, GraphSAGE, SAGEConv, params_from_flax
from dgll_tpu_torch.ops import spmm
from dgll_tpu_torch.sampling import HostGraph, NeighborSampler
from dgll_tpu_torch.train import MiniBatchTrainer
from test_torch_edge_ops import _thread_pool  # noqa: F401 (fixture)

GRAPH = dict(n_node=300, avg_degree=5, n_class=4, feat_dim=16, power_law=1.0, seed=1)
FANOUTS = [3, 2]
BATCH = 24


@pytest.fixture(scope="module")
def data():
    gt = gcn_normalize(synthetic_classification_graph(**GRAPH))
    gj = jax_gcn_normalize(jax_synthetic(**GRAPH))
    np.testing.assert_array_equal(gt.node_feat.numpy(), np.asarray(gj.node_feat))
    np.testing.assert_array_equal(gt.src.numpy(), np.asarray(gj.src))
    return gt, gj, HostGraph.from_graph(gt), JaxHostGraph.from_graph(gj)


def _blocks(data, seed=0):
    gt, gj, ht, hj = data
    seeds = np.random.default_rng(seed).choice(gt.n_real_node, BATCH - 4, replace=False)
    _, _, bt = NeighborSampler(FANOUTS, seed=seed).sample(ht, seeds, pad_to=BATCH)
    _, _, bj = JaxSampler(FANOUTS, seed=seed).sample(hj, seeds, pad_to=BATCH)
    xt = gt.node_feat.index_select(0, bt[0].src_ids)
    return bt, bj, xt, jnp.asarray(xt.numpy())


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("kind", ["mean", "sum", "max"])
def test_block_aggregate_matches_jax(data, kind):
    bt, bj, _, _ = _blocks(data)
    b_t, b_j = bt[0], bj[0]
    x = np.random.default_rng(2).normal(size=(b_t.n_src, 7)).astype(np.float32)
    got = spmm.block_aggregate(torch.from_numpy(x), b_t.n_dst, b_t.fanout, b_t.neigh_mask,
                               kind)
    want = jax_spmm.block_aggregate(jnp.asarray(x), b_j.n_dst, b_j.fanout,
                                    jnp.asarray(b_j.neigh_mask), kind)
    assert got.shape == (b_t.n_dst, 7)
    _close(got, want, 1e-6)
    if kind == "sum":  # the mask-weighted mean: spmm_coo over the block's COO view
        coo = spmm.spmm_coo(b_t.src, b_t.dst, torch.from_numpy(x), b_t.n_dst,
                            b_t.edge_weight)
        _close(got, coo, 1e-6)
    with pytest.raises(ValueError):
        spmm.block_aggregate(torch.from_numpy(x), b_t.n_dst, b_t.fanout, b_t.neigh_mask,
                             "min")


@pytest.mark.parametrize("op", ["mean", "max"])
def test_coo_mean_and_max_match_jax_with_gradients(op):
    """Duplicated edges tie the max; rows 0 and 9 have no in-edge (output 0)."""
    rng = np.random.default_rng(3)
    src = np.concatenate([rng.integers(0, 12, 40), [5, 5, 5]]).astype(np.int32)
    dst = np.concatenate([rng.integers(1, 9, 40), [4, 4, 4]]).astype(np.int32)
    x = rng.normal(size=(12, 6)).astype(np.float32)
    cot = rng.normal(size=(10, 6)).astype(np.float32)
    ft = {"mean": spmm.spmm_mean_coo, "max": spmm.spmm_max_coo}[op]
    fj = {"mean": jax_spmm.spmm_mean_coo, "max": jax_spmm.spmm_max_coo}[op]
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ft(torch.from_numpy(src), torch.from_numpy(dst), xt, 10)
    (out * torch.from_numpy(cot)).sum().backward()
    want, vjp = jax.vjp(lambda v: fj(jnp.asarray(src), jnp.asarray(dst), v, 10),
                        jnp.asarray(x))
    _close(out.detach(), want, 1e-6)
    _close(xt.grad, vjp(jnp.asarray(cot))[0], 1e-6)
    assert not out[0].any() and not out[9].any()


def _sage_pair(in_f, feats, aggregator, combine, g_t, g_j, x_t, x_j):
    mj = JaxSAGEConv(feats, aggregator=aggregator, combine=combine)
    params = mj.init(jax.random.key(0), g_j, x_j)["params"]
    mt = SAGEConv(in_f, feats, aggregator, combine)
    state = params_from_flax({"SAGEConv_0": _np(params)})
    mt.load_state_dict({k.removeprefix("convs.0."): v for k, v in state.items()})
    return mt(g_t, x_t), mj.apply({"params": params}, g_j, x_j)


@pytest.mark.parametrize("aggregator", ["mean", "sum", "max"])
@pytest.mark.parametrize("combine", ["concat", "sum"])
def test_sage_conv_on_a_block_matches_jax(data, aggregator, combine):
    bt, bj, xt, xj = _blocks(data, seed=1)
    got, want = _sage_pair(16, 8, aggregator, combine, bt[0], bj[0], xt, xj)
    assert got.shape == (bt[0].n_dst, 16 if combine == "concat" else 8)
    _close(got.detach(), want, 1e-5)


@pytest.mark.parametrize("aggregator", ["mean", "sum", "max"])
@pytest.mark.parametrize("combine", ["concat", "sum"])
def test_sage_conv_on_the_full_graph_matches_jax(data, aggregator, combine):
    gt, gj, _, _ = data
    got, want = _sage_pair(16, 8, aggregator, combine, gt, jax.tree.map(jnp.asarray, gj),
                           gt.node_feat, jnp.asarray(gj.node_feat))
    assert got.shape == (gt.n_node, 16 if combine == "concat" else 8)
    _close(got.detach(), want, 1e-5)


def _models(name, dropout=0.0):
    """The JAX model, and a function that makes the torch model of the same shape."""
    if name == "GraphSAGE":
        return (JaxGraphSAGE(hidden=16, n_class=4, dropout=dropout),
                lambda: GraphSAGE(16, 16, 4, dropout=dropout))
    return (JaxGCN(hidden=16, n_class=4, dropout=dropout),
            lambda: GCN(16, 16, 4, dropout=dropout))


def _init(name, data, dropout=0.0):
    mj, build = _models(name, dropout)
    _, bj, _, xj = _blocks(data, seed=9)
    params = mj.init(jax.random.key(3), list(bj), xj)["params"]
    mt = build()
    mt.load_state_dict(params_from_flax(_np(params)))
    return mj, params, mt


@pytest.mark.parametrize("name", ["GraphSAGE", "GCN"])
def test_models_on_blocks_match_jax_with_gradients(data, name):
    mj, params, mt = _init(name, data)
    bt, bj, xt, xj = _blocks(data, seed=2)
    cot = np.random.default_rng(4).normal(size=(BATCH, 4)).astype(np.float32)
    xt = xt.clone().requires_grad_(True)
    out = mt(bt, xt)
    (out * torch.from_numpy(cot)).sum().backward()

    def f(p, x):
        return (mj.apply({"params": p}, list(bj), x) * cot).sum()

    want = mj.apply({"params": params}, list(bj), xj)
    gp, gx = jax.grad(f, argnums=(0, 1))(params, xj)
    _close(out.detach(), want, 1e-5, "out")
    _close(xt.grad, gx, 1e-5, "dx")
    grads = {k: p.grad for k, p in mt.named_parameters()}
    want_grads = params_from_flax(_np(gp))
    assert set(grads) == set(want_grads)
    for k, v in want_grads.items():
        _close(grads[k], v, 1e-5, k)
    with pytest.raises(ValueError, match="need 2 blocks"):
        mt(bt[:1], xt)


OPTIMIZERS = {
    "sgd": (optax.sgd(0.05), functools.partial(torch.optim.SGD, lr=0.05)),
    "adam": (optax.adam(1e-2), functools.partial(torch.optim.Adam, lr=1e-2)),
}


def _jax_epochs(mj, params, tx, data, epochs, fetch=None):
    _, gj, _, hj = data
    tr = JaxTrainer(mj, tx, seed=0)
    state = JaxTrainState.create(apply_fn=mj.apply, params=params, tx=tx)
    loader = JaxDataLoader(hj, gj.get_train_nodes(), JaxSampler(FANOUTS, seed=0), BATCH,
                           seed=0)
    losses = []
    for _ in range(epochs):
        state, loss, _ = tr.run_epoch(state, loader, gj.node_feat, gj.labels,
                                      fetch_fn=fetch)
        losses.append(loss)
    return losses, tr, state


def _torch_epochs(mt, opt, data, epochs, fetch=None, features=True):
    gt, _, ht, _ = data
    tr = MiniBatchTrainer(mt, opt, seed=0, device="cpu")
    state = tr.init_state()
    loader = DataLoader(ht, gt.get_train_nodes(), NeighborSampler(FANOUTS, seed=0), BATCH,
                        seed=0, device="cpu")
    losses = []
    for _ in range(epochs):
        state, loss, secs = tr.run_epoch(state, loader, gt.node_feat if features else None,
                                         gt.labels, fetch_fn=fetch)
        assert secs > 0
        losses.append(loss)
    return losses, tr, state


@pytest.mark.parametrize("name", ["GraphSAGE", "GCN"])
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_trainer_epochs_match_jax(data, name, opt):
    tx, opt_t = OPTIMIZERS[opt]
    mj, params, mt = _init(name, data)
    lj, tr_j, state_j = _jax_epochs(mj, params, tx, data, 2)
    lt, tr_t, state_t = _torch_epochs(mt, opt_t, data, 2)
    assert state_t.step == 2 * -(-len(data[0].get_train_nodes()) // BATCH)
    _close(lt, lj, 1e-4)
    # sampled evaluation over the same validation batches
    gt, gj, ht, hj = data

    def val_t():
        return DataLoader(ht, gt.get_validation_nodes(), NeighborSampler(FANOUTS, seed=1),
                          BATCH, shuffle=False, seed=1)

    val_j = JaxDataLoader(hj, gj.get_validation_nodes(), JaxSampler(FANOUTS, seed=1),
                          BATCH, shuffle=False, seed=1)
    pred_t, y_t = tr_t.predict_nodes(state_t, val_t(), gt.node_feat, gt.labels)
    pred_j, y_j = tr_j.predict_nodes(state_j, val_j, gj.node_feat, gj.labels)
    np.testing.assert_array_equal(y_t, y_j)
    assert len(pred_t) == len(gt.get_validation_nodes())
    assert (pred_t == pred_j).mean() > 0.95  # argmax of logits within 1e-4
    acc = tr_t.evaluate_nodes(state_t, val_t(), gt.node_feat, gt.labels)
    assert acc == float((pred_t == y_t).mean())


def test_whole_graph_cache_epoch_matches_the_plain_gather(data):
    gt = data[0]
    cache = HBMFeatureCache(gt.node_feat.numpy(), device="cpu")
    cache.fill(np.arange(gt.n_node))
    runs = []
    for fetch in (None, cache.fetch):
        _, _, mt = _init("GraphSAGE", data)
        runs.append(_torch_epochs(mt, OPTIMIZERS["sgd"][1], data, 2, fetch,
                                  features=fetch is None)[0])
    _close(runs[1], runs[0], 1e-6)
    rate, lookups, _ = cache.miss_rate()
    assert rate == 0.0 and lookups > 0


def test_int8_cache_epoch_matches_jax(data):
    gt, gj, _, _ = data
    feats = gt.node_feat.numpy()
    hot = np.argsort(-gt.out_degrees_np(), kind="stable")[:150]
    ct = HBMFeatureCache(feats, device="cpu", quantize=True)
    cj = JaxCache(np.asarray(gj.node_feat), quantize=True)
    ct.fill(hot)
    cj.fill(hot)
    mj, params, mt = _init("GraphSAGE", data)
    tx, opt_t = OPTIMIZERS["adam"]
    lj, _, _ = _jax_epochs(mj, params, tx, data, 2, lambda ids: cj.fetch(np.asarray(ids)))
    lt, _, _ = _torch_epochs(mt, opt_t, data, 2, ct.fetch, features=False)
    _close(lt, lj, 1e-4)
    assert ct.miss_rate() == cj.miss_rate() and 0 < ct.miss_rate()[0] < 1


def test_dropout_draws_from_the_trainer_generator(data):
    runs = []
    for seed in (0, 0, 1):
        _, _, mt = _init("GraphSAGE", data, dropout=0.5)
        gt, _, ht, _ = data
        tr = MiniBatchTrainer(mt, OPTIMIZERS["sgd"][1], seed=seed, device="cpu")
        loader = DataLoader(ht, gt.get_train_nodes(), NeighborSampler(FANOUTS, seed=0),
                            BATCH, seed=0)
        runs.append(tr.run_epoch(tr.init_state(), loader, gt.node_feat, gt.labels)[1])
    assert runs[0] == runs[1] != runs[2]


CLI = ["--samp_type", "neighbor", "--n_node", "600", "--n_epochs", "3",
       "--batch_size", "64", "--nhid", "16", "--feat_dim", "16"]


@pytest.mark.parametrize("args", [
    ["--Model", "GraphSAGE", "--cached_nPercent", "25"],
    ["--Model", "GCN"],
    ["--Model", "GCN", "--n_parts", "2"],
    ["--Model", "GraphSAGE", "--sage_aggregator", "max", "--sage_combine", "sum",
     "--cached_nPercent", "100"],
])
def test_cli_host_branch_prints_the_jax_cli_keys(args):
    want = jax_main(CLI + args)
    got = torch_run.main(CLI + args + ["--device", "cpu"])
    assert set(got) == set(want) == {"config", "trials", "aggregate"}
    assert set(got["config"]) == set(want["config"]) | {"device"}
    assert set(got["trials"][0]) == set(want["trials"][0]) | {"epoch_loss", "epoch_s"}
    assert set(got["aggregate"]) == set(want["aggregate"])
    trial = got["trials"][0]
    losses = trial["epoch_loss"]
    assert trial["epochs"] == 3 and len(losses) == len(trial["epoch_s"]) == 3
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert 0 <= trial["test_acc"] <= 1
    if "--cached_nPercent" in args:
        assert trial["cached_rows"] == want["trials"][0]["cached_rows"]
        assert trial["cache_lookups"] > 0
    if "--n_parts" in args:
        assert trial["n_communities"] == want["trials"][0]["n_communities"]


def test_cli_full_batch_graphsage_runs():
    got = torch_run.main(["--samp_type", "full", "--Model", "GraphSAGE", "--n_node", "600",
                          "--n_epochs", "3", "--device", "cpu"])
    trial = got["trials"][0]
    assert trial["epochs"] == 3 and trial["test_acc"] > 1 / 16
    assert "spmm_kernel" not in trial
