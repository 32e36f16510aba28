"""Parity of the port's device epoch, eval sweep, exact inference and dense-block
``GATConv`` with the JAX package's.

The epochs: ``DeviceEpochRunner`` in both packages, from the same parameters
(``params_from_flax``), with Adam and dropout 0; the port is handed the permutation
and the uniforms of the JAX runner's key chain (``split(key)`` into the permutation's
and the scan's keys, ``split(k, 3)`` a batch, ``fold_in(ks, li)`` a layer, and
``split`` into the anchor's and the slots' keys in window mode), so both sample the
same blocks. Tolerances, the host minibatch tests' bars (``test_torch_minibatch.py``):
the per-epoch losses within 1e-4 and the parameters within 1e-5 (float32, sums in
another order, two epochs of Adam). The eval sweep's predictions equal the JAX
package's wherever its logits' top-two margin exceeds 1e-4; exact inference's equal
it everywhere, their log-probabilities within 1e-5; the dense-block ``GATConv``'s
output and gradients within 1e-5. Under bfloat16 (both runners given it as
``feat_dtype``): GraphSAGE's exact log-probabilities within 1e-2 x max|ref| and an
epoch's loss within 1e-2, relative (bf16's 8 significant bits, sums in other orders),
both packages' exact log-probabilities held to the JAX model's in float32, the port's
no farther from them than JAX's (its full-graph mean sums bfloat16 in float32).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dgll_tpu.data import gcn_normalize as jax_gcn_normalize
from dgll_tpu.data import synthetic_classification_graph as jax_synthetic
from dgll_tpu.nn import GAT as JaxGAT
from dgll_tpu.nn import GCN as JaxGCN
from dgll_tpu.nn import GraphSAGE as JaxGraphSAGE
from dgll_tpu.nn.conv import GATConv as JaxGATConv
from dgll_tpu.sampling import device_sampler as jds
from dgll_tpu.train import DeviceEpochRunner as JaxRunner
from dgll_tpu.train import exact_predict as jax_exact_predict
from dgll_tpu_torch.data import gcn_normalize, synthetic_classification_graph
from dgll_tpu_torch.nn import GAT, GCN, GATConv, GraphSAGE, params_from_flax
from dgll_tpu_torch.sampling import DeviceCSR, sample_blocks_device
from dgll_tpu_torch.sampling.device_sampler import layer_sizes
from dgll_tpu_torch.train import (
    DeviceEpochRunner,
    EpochDraws,
    exact_accuracy,
    exact_predict,
    make_sample_fn,
)
from test_torch_edge_ops import _thread_pool  # noqa: F401 (fixture)

GRAPH = dict(n_node=1500, avg_degree=6, n_class=4, feat_dim=16, power_law=1.0, seed=3,
             train_frac=0.4)
FANOUTS = [5, 3]
BATCH = 64


@pytest.fixture(scope="module")
def data():
    gt = gcn_normalize(synthetic_classification_graph(**GRAPH))
    gj = jax_gcn_normalize(jax_synthetic(**GRAPH))
    np.testing.assert_array_equal(gt.node_feat.numpy(), np.asarray(gj.node_feat))
    np.testing.assert_array_equal(gt.src.numpy(), np.asarray(gj.src))
    return gt, gj, DeviceCSR.from_graph(gt, "cpu"), jds.DeviceCSR.from_graph(gj)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


def _models(name):
    if name == "GraphSAGE":
        return JaxGraphSAGE(hidden=16, n_class=4, dropout=0.0), GraphSAGE(16, 16, 4, dropout=0.0)
    return JaxGCN(hidden=16, n_class=4, dropout=0.0), GCN(16, 16, 4, dropout=0.0)


def layer_draws(key, n, fanout, window):
    if window:
        ka, kl = jax.random.split(key)
        return (np.asarray(jax.random.uniform(ka, (n,))),
                np.asarray(jax.random.uniform(kl, (n, fanout))))
    return np.asarray(jax.random.uniform(key, (n, fanout)))


def batch_draws(ks, window, batch=BATCH):
    """One batch's per-layer uniforms from its sampling key ``ks``."""
    rev = list(reversed(FANOUTS))
    return [layer_draws(jax.random.fold_in(ks, li), n, f, window)
            for li, (n, f) in enumerate(zip(layer_sizes(batch, FANOUTS), rev))]


def _torch(d):
    return tuple(torch.from_numpy(np.array(t)) for t in d) if isinstance(d, tuple) \
        else torch.from_numpy(np.array(d))


def jax_epoch_draws(key, n_batches, window) -> EpochDraws:
    """The permutation and uniforms of ``make_device_epoch_fn``'s epoch for ``key``."""
    kperm, k = jax.random.split(key)
    order = np.asarray(jax.random.permutation(kperm, n_batches * BATCH))
    per_batch = []
    for _ in range(n_batches):
        k, ks, _ = jax.random.split(k, 3)
        per_batch.append(batch_draws(ks, window))
    uniforms = []
    for li in range(len(FANOUTS)):
        layer = [b[li] for b in per_batch]
        if window:
            uniforms.append(tuple(_torch(np.stack([b[j] for b in layer])) for j in (0, 1)))
        else:
            uniforms.append(_torch(np.stack(layer)))
    return EpochDraws(torch.from_numpy(order.astype(np.int64)), uniforms)


def runners(data, name, window):
    gt, gj, ct, cj = data
    mj, mt = _models(name)
    rj = JaxRunner(mj, optax.adam(1e-2), cj, FANOUTS, BATCH, gj.get_train_nodes(), seed=0,
                   window=window)
    state_j = rj.init_state(jnp.asarray(gj.node_feat))
    mt.load_state_dict(params_from_flax(_np(state_j.params)))
    rt = DeviceEpochRunner(mt, functools.partial(torch.optim.Adam, lr=1e-2), ct, FANOUTS,
                           BATCH, gt.get_train_nodes(), window=window)
    return rj, state_j, rt, rt.init_state(gt.node_feat)


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("name", ["GraphSAGE", "GCN"])
def test_two_epochs_match_jax(data, name, window):
    gt, gj, _, _ = data
    rj, state_j, rt, state_t = runners(data, name, window)
    assert rt.n_batches == rj.n_batches > 5 and not rt.cuda_graph
    feats_j, labels_j = jnp.asarray(gj.node_feat), jnp.asarray(gj.labels)
    for _ in range(2):
        key = jax.random.split(rj.rng)[1]   # the key run_epoch draws next
        draws = jax_epoch_draws(key, rj.n_batches, window)
        state_j, loss_j = rj.run_epoch(state_j, feats_j, labels_j)
        state_t, loss_t = rt.run_epoch(state_t, gt.node_feat, gt.labels, draws=draws)
        assert loss_t.dim() == 0
        _close(float(loss_t), float(loss_j), 1e-4, "epoch loss")
        _close(loss_t, rt.batch_losses.mean(), 0)
    assert state_t.step == 2 * rt.n_batches
    got = dict(state_t.model.named_parameters())
    want = params_from_flax(_np(state_j.params))
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k].detach(), v, 1e-5, k)


def test_epochs_draw_from_the_runner_generator(data):
    """Without injected draws the epoch is a function of the runner's seed."""
    gt = data[0]
    losses = []
    for seed in (0, 0, 1):
        rt = DeviceEpochRunner(GraphSAGE(16, 16, 4, dropout=0.5,
                                         generator=torch.Generator().manual_seed(0)),
                               functools.partial(torch.optim.Adam, lr=1e-2), data[2],
                               FANOUTS, BATCH, gt.get_train_nodes(), seed=seed)
        state = rt.init_state()
        losses.append([float(rt.run_epoch(state, gt.node_feat, gt.labels)[1])
                       for _ in range(2)])
    assert losses[0] == losses[1] != losses[2]
    assert all(np.isfinite(losses[0]))


def jax_sweep_logits(mj, params, cj, feats, nodes, seed):
    """``make_device_eval_fn``'s batches, with the logits: ``(logits, draws)``."""
    nb = -(-len(nodes) // BATCH)
    seeds = np.zeros(nb * BATCH, np.int32)
    seeds[: len(nodes)] = nodes
    mask = np.arange(nb * BATCH) < len(nodes)
    key = jax.random.key(seed)
    logits, draws = [], []
    for i in range(nb):
        ki = jax.random.fold_in(key, i)
        _, _, blocks = jds.sample_blocks_device(
            cj, jnp.asarray(seeds[i * BATCH:(i + 1) * BATCH]),
            jnp.asarray(mask[i * BATCH:(i + 1) * BATCH]), FANOUTS, ki)
        x = jnp.take(feats, blocks[0].src_ids, axis=0)
        logits.append(np.asarray(mj.apply({"params": params}, list(blocks), x)))
        draws.append([_torch(d) for d in batch_draws(ki, False)])
    return np.concatenate(logits)[: len(nodes)], draws


@pytest.mark.parametrize("name", ["GraphSAGE", "GCN"])
def test_eval_sweep_matches_jax(data, name):
    gt, gj, _, cj = data
    rj, state_j, rt, state_t = runners(data, name, False)
    feats_j = jnp.asarray(gj.node_feat)
    state_j, _ = rj.run_epoch(state_j, feats_j, jnp.asarray(gj.labels))
    state_t.model.load_state_dict(params_from_flax(_np(state_j.params)))
    nodes = gt.get_validation_nodes()
    want = rj.predict_nodes(state_j, feats_j, nodes, seed=5)
    logits, draws = jax_sweep_logits(rj.model, state_j.params, cj, feats_j, nodes, 5)
    np.testing.assert_array_equal(want, logits.argmax(-1))
    got = rt.predict_nodes(state_t, gt.node_feat, nodes, draws=draws)
    top2 = np.sort(logits, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-4
    assert got.shape == want.shape and clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])
    # the port's own draws: deterministic given the seed
    a = rt.predict_nodes(state_t, gt.node_feat, nodes, seed=5)
    np.testing.assert_array_equal(a, rt.predict_nodes(state_t, gt.node_feat, nodes, seed=5))
    labels = gt.labels.numpy()
    assert rt.evaluate_nodes(state_t, gt.node_feat, labels, nodes, seed=5) == \
        float((a == labels[nodes]).mean())
    assert rt.evaluate_nodes(state_t, gt.node_feat, labels, []) == 0.0


@pytest.mark.parametrize("name", ["GraphSAGE", "GCN"])
def test_exact_inference_matches_jax(data, name):
    gt, gj, _, _ = data
    rj, state_j, rt, state_t = runners(data, name, False)
    gjd = jax.tree.map(jnp.asarray, gj)
    want = jax_exact_predict(rj.model.apply, state_j.params, gjd, gjd.node_feat)
    want_logp = np.asarray(rj.model.apply({"params": state_j.params}, gjd, gjd.node_feat))
    state_t.model.train()
    got = exact_predict(state_t.model, gt, gt.node_feat)
    assert state_t.model.training   # the forward ran in eval mode and put it back
    assert got.dtype == np.int32 and got.shape == (gt.n_real_node,)
    np.testing.assert_array_equal(got, want)
    with torch.no_grad():
        _close(state_t.model.eval()(gt, gt.node_feat), want_logp, 1e-5)
    nodes = gt.get_test_nodes()
    np.testing.assert_array_equal(rt.predict_nodes_exact(state_t, gt, gt.node_feat, nodes),
                                  want[nodes])
    labels = gt.labels.numpy()
    acc = exact_accuracy(state_t.model, gt, gt.node_feat, labels, nodes)
    assert acc == float((want[nodes] == labels[nodes]).mean()) == \
        rt.evaluate_nodes_exact(state_t, gt, gt.node_feat, labels, nodes)


def test_runner_exact_inference_in_bf16_matches_jax(data):
    """Both runners given bfloat16 as ``feat_dtype``: GraphSAGE aggregates the cast
    features before its first ``Dense``. Both packages' log-probabilities are held to
    the exact ones: the JAX model in float32 on the same bfloat16-rounded features
    (float32's 24 significant bits against bf16's 8). The port's within 1e-2 x
    max|exact| of them (bf16 keeps 8 significant bits) and no farther from them than
    the JAX package's (its full-graph mean sums bfloat16 in bfloat16, the port's K1
    in float32); its predictions equal the exact ones wherever their top-two margin
    exceeds twice that, and the JAX runner's wherever both packages' margins do; an
    epoch's mean loss within 1e-2 of JAX's, relative."""
    from dgll_tpu.train.exact_infer import make_exact_logits_fn

    from dgll_tpu_torch.train.exact_infer import exact_logits

    gt, gj, ct, cj = data
    mj = JaxGraphSAGE(hidden=16, n_class=4, dropout=0.0, dtype=jnp.bfloat16)
    mt = GraphSAGE(16, 16, 4, dropout=0.0, dtype=torch.bfloat16)
    rj = JaxRunner(mj, optax.adam(1e-2), cj, FANOUTS, BATCH, gj.get_train_nodes(), seed=0,
                   feat_dtype=jnp.bfloat16)
    state_j = rj.init_state(jnp.asarray(gj.node_feat))
    mt.load_state_dict(params_from_flax(_np(state_j.params)))
    rt = DeviceEpochRunner(mt, functools.partial(torch.optim.Adam, lr=1e-2), ct, FANOUTS,
                           BATCH, gt.get_train_nodes(), feat_dtype=torch.bfloat16)
    state_t = rt.init_state(gt.node_feat)
    gjd = jax.tree.map(jnp.asarray, gj)
    nodes = gt.get_test_nodes()
    want = rj.predict_nodes_exact(state_j, gjd, gjd.node_feat, nodes)
    logp = np.asarray(make_exact_logits_fn(mj.apply, jnp.bfloat16)(
        state_j.params, gjd, gjd.node_feat).astype(jnp.float32))
    got_logp = exact_logits(state_t.model, gt, gt.node_feat, feat_dtype=torch.bfloat16)
    assert got_logp.dtype == torch.bfloat16
    rounded = gjd.node_feat.astype(jnp.bfloat16).astype(jnp.float32)
    exact = np.asarray(make_exact_logits_fn(JaxGraphSAGE(
        hidden=16, n_class=4, dropout=0.0).apply)(state_j.params, gjd, rounded))
    tol = 1e-2 * np.abs(exact).max()
    got_logp = got_logp.float().numpy()
    np.testing.assert_allclose(got_logp, exact, rtol=0, atol=tol)
    assert np.abs(got_logp - exact).max() <= np.abs(logp - exact).max()
    got = rt.predict_nodes_exact(state_t, gt, gt.node_feat, nodes)
    margin = {k: np.diff(np.sort(v[nodes], -1)[:, -2:], axis=-1)[:, 0]
              for k, v in (("exact", exact), ("jax", logp))}
    clear = margin["exact"] > 2 * tol
    assert got.shape == want.shape and clear.mean() > 0.5
    np.testing.assert_array_equal(got[clear], exact[nodes].argmax(-1)[clear])
    both = clear & (margin["jax"] > 2 * tol)
    assert both.mean() > 0.5
    np.testing.assert_array_equal(got[both], np.asarray(want)[both])
    np.testing.assert_array_equal(
        got, exact_predict(state_t.model, gt, gt.node_feat, nodes, torch.bfloat16))
    labels = gt.labels.numpy()
    assert rt.evaluate_nodes_exact(state_t, gt, gt.node_feat, labels, nodes) == \
        float((got == labels[nodes]).mean())
    # an epoch on the JAX runner's draws: the batches' features cast as JAX's are
    key = jax.random.split(rj.rng)[1]
    draws = jax_epoch_draws(key, rj.n_batches, False)
    _, loss_j = rj.run_epoch(state_j, jnp.asarray(gj.node_feat), jnp.asarray(gj.labels))
    seen = []
    hook = mt.register_forward_pre_hook(lambda m, args: seen.append(args[1].dtype))
    _, loss_t = rt.run_epoch(state_t, gt.node_feat, gt.labels, draws=draws)
    hook.remove()
    assert len(seen) == rt.n_batches and set(seen) == {torch.bfloat16}
    _close(float(loss_t), float(loss_j), 1e-2 * abs(float(loss_j)), "bf16 epoch loss")


def _block_pair(data, seed=0):
    _, _, ct, cj = data
    seeds = np.random.default_rng(seed).integers(0, 1500, 24).astype(np.int32)
    mask = np.arange(24) < 20
    key = jax.random.key(seed)
    _, _, bj = jds.sample_blocks_device(cj, jnp.asarray(seeds), jnp.asarray(mask),
                                        FANOUTS, key)
    _, _, bt = sample_blocks_device(ct, torch.from_numpy(seeds), torch.from_numpy(mask),
                                    FANOUTS, draws=[_torch(d) for d in batch_draws(key, False, 24)])
    return bt, bj


@pytest.mark.parametrize("heads, concat", [(1, False), (3, True), (3, False)])
def test_dense_block_gat_conv_matches_jax_with_gradients(data, heads, concat):
    bt, bj = _block_pair(data)
    b_t, b_j = bt[-1], bj[-1]
    x = np.random.default_rng(1).normal(size=(b_t.n_src, 12)).astype(np.float32)
    mj = JaxGATConv(5, num_heads=heads, concat_heads=concat)
    params = mj.init(jax.random.key(2), b_j, jnp.asarray(x))["params"]
    mt = GATConv(12, 5, heads, concat_heads=concat)
    state = params_from_flax({"GATConv_0": _np(params)})
    mt.load_state_dict({k.removeprefix("convs.0."): v for k, v in state.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mt(b_t, xt)
    cot = np.random.default_rng(3).normal(size=tuple(out.shape)).astype(np.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    want = mj.apply({"params": params}, b_j, jnp.asarray(x))
    gp, gx = jax.grad(lambda p, v: (mj.apply({"params": p}, b_j, v) * cot).sum(),
                      argnums=(0, 1))(params, jnp.asarray(x))
    assert out.shape == (24, 5 * heads if concat else 5)
    _close(out.detach(), want, 1e-5, "out")
    _close(xt.grad, gx, 1e-5, "dx")
    want_grads = {k.removeprefix("convs.0."): v
                  for k, v in params_from_flax({"GATConv_0": _np(gp)}).items()}
    for k, p in mt.named_parameters():
        _close(p.grad, want_grads[k], 1e-5, k)


def test_gat_model_on_blocks_matches_jax(data):
    bt, bj = _block_pair(data, seed=4)
    gt = data[0]
    x = gt.node_feat.index_select(0, bt[0].src_ids)
    mj = JaxGAT(hidden=4, n_class=4, num_heads=2, dropout=0.5)
    params = mj.init(jax.random.key(0), list(bj), jnp.asarray(x.numpy()))["params"]
    mt = GAT(16, 4, 4, num_heads=2, dropout=0.5)
    mt.load_state_dict(params_from_flax(_np(params)))
    _close(mt.eval()(bt, x).detach(), mj.apply({"params": params}, list(bj),
                                                jnp.asarray(x.numpy())), 1e-5)
    mt.train()   # attention and feature dropout from the generator, on the blocks
    gen = torch.Generator().manual_seed(0)
    out = mt(bt, x, generator=gen)
    assert out.shape == (24, 4) and torch.isfinite(out).all()


def test_runner_refuses_what_it_cannot_run(data):
    gt, _, ct, _ = data
    with pytest.raises(ValueError, match="unknown device sampler"):
        make_sample_fn(FANOUTS, sampler="graphsaint")
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA device"):
        DeviceEpochRunner(GraphSAGE(16, 16, 4), torch.optim.Adam, ct, FANOUTS, BATCH,
                          gt.get_train_nodes(), cuda_graph=True)
    rt = DeviceEpochRunner(GraphSAGE(16, 16, 4), torch.optim.Adam, ct, FANOUTS, BATCH,
                           gt.get_train_nodes())
    with pytest.raises(ValueError, match="capturable"):
        rt.capture(rt.init_state(), gt.node_feat, gt.labels)
