"""Parity of the port's device layer-wise samplers (``sampling/device_layerwise.py``)
and of ``DeviceEpochRunner`` on them with the JAX package's.

The tables (Vose's alias table, the ELL-packed Laplacian, the FastGCN
probabilities) are built by the same numpy in the same order: exactly equal. The
layers run on the JAX package's uniforms (``split(fold_in(key, li))`` for FastGCN,
``fold_in(key, li)`` for LADIES): FastGCN's blocks are exactly equal. LADIES's
prefix sum adds in another order in XLA and in torch, so a drawn id may differ
where its uniform lies within rounding of a boundary of the prefix sum (within
``nK * 2^-24`` of the total, the float32 bound for a sum of ``nK`` non-negative
terms); every other pick is equal, and where all are, the slots are equal and the
weights within rtol 1e-5 (LADIES's column sums add in another order). The unbiased
estimator is checked as the JAX package's test does, with a seeded torch generator.
Two ``DeviceEpochRunner`` epochs a mode on the JAX runner's permutation and
uniforms: losses within 1e-4, parameters within 1e-5.
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
from dgll_tpu.nn import GCN as JaxGCN
from dgll_tpu.sampling import build_device_lap as jax_build_lap
from dgll_tpu.sampling import device_layerwise as jdl
from dgll_tpu.sampling.device_layerwise import build_alias_table as jax_alias_table
from dgll_tpu.train import DeviceEpochRunner as JaxRunner
from dgll_tpu.train import exact_predict as jax_exact_predict
from dgll_tpu_torch.data import gcn_normalize, synthetic_classification_graph
from dgll_tpu_torch.nn import GCN, params_from_flax
from dgll_tpu_torch.sampling import (
    DeviceLayerWiseSampler,
    build_alias_table,
    build_device_lap,
    normalized_laplacian,
    sample_blocks_device_layerwise,
)
from dgll_tpu_torch.sampling.device_layerwise import _layer
from dgll_tpu_torch.train import DeviceEpochRunner, EpochDraws, draw_epoch, make_sample_fn
from test_torch_edge_ops import _thread_pool  # noqa: F401 (fixture)

GRAPH = dict(n_node=400, avg_degree=6, n_class=4, feat_dim=16, power_law=1.0, seed=3,
             train_frac=0.4)
SIZES = [48, 24]
BATCH = 16
MODES = ["fastgcn", "ladies"]


@pytest.fixture(scope="module")
def data():
    gt = gcn_normalize(synthetic_classification_graph(**GRAPH))
    gj = jax_gcn_normalize(jax_synthetic(**GRAPH))
    return gt, gj, build_device_lap(gt, k=32, device="cpu"), jax_build_lap(gj, k=32)


def _unpack(packed, n):
    return np.asarray(packed).reshape(-1)[:n]


@pytest.mark.parametrize("case", ["random", "zeros_inside", "all_zero", "one"])
def test_alias_table_equals_jax(case):
    rng = np.random.default_rng(5)
    p = {"random": rng.random(300), "zeros_inside": rng.random(300) * (rng.random(300) > 0.5),
         "all_zero": np.zeros(40), "one": np.array([2.0])}[case]
    pt, at = build_alias_table(p)
    pj, aj = jax_alias_table(p)
    assert pt.dtype == pj.dtype == np.float32 and at.dtype == aj.dtype == np.int64
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(at, aj)


@pytest.mark.parametrize("k, flatten", [(32, False), (4, False), (4, True)])
def test_device_lap_equals_jax(k, flatten):
    gt = synthetic_classification_graph(**GRAPH)
    gj = jax_synthetic(**GRAPH)
    lt = build_device_lap(gt, k=k, flatten=flatten, device="cpu")
    lj = jax_build_lap(gj, k=k, flatten=flatten)
    assert (lt.n_node, lt.k) == (lj.n_node, lj.k) and lt.device.type == "cpu"
    np.testing.assert_array_equal(lt.ell_col.numpy(), np.asarray(lj.ell_col))
    np.testing.assert_array_equal(lt.ell_val.numpy(), np.asarray(lj.ell_val))
    for name, packed in (("pfull", lj.p_packed), ("alias_prob", lj.alias_prob_p),
                         ("alias_idx", lj.alias_idx_p)):
        got = getattr(lt, name).numpy()
        want = _unpack(packed, lj.n_node)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    if k == 4:  # rows above K keep their heaviest entries
        lap = normalized_laplacian(gt)
        deg = np.diff(lap.indptr)
        assert (deg > k).any() and (lt.ell_col.numpy() >= 0).sum() == np.minimum(deg, k).sum()


def layer_draws(key, s, mode):
    """One layer's uniforms, as the JAX package's ``_layer`` draws them from
    ``key``."""
    if mode == "fastgcn":
        k1, k2 = jax.random.split(key)
        return (torch.from_numpy(np.array(jax.random.uniform(k1, (s,)))),
                torch.from_numpy(np.array(jax.random.uniform(k2, (s,)))))
    return torch.from_numpy(np.array(jax.random.uniform(key, (s,))))


def batch_draws(ks, mode, sizes=SIZES):
    return [layer_draws(jax.random.fold_in(ks, li), s, mode)
            for li, s in enumerate(reversed(sizes))]


def ladies_ties(lap, prev_ids, prev_mask, u, drawn_t, drawn_j) -> int:
    """The draws that differ, each asserted to lie within rounding of a boundary of
    the prefix sum: ``|u tot - cum[j]| <= nK 2^-24 tot`` for some ``j``."""
    differ = np.flatnonzero(drawn_t != drawn_j)
    if len(differ) == 0:
        return 0
    safe = np.where(prev_mask, prev_ids, 0)
    vals = lap.ell_val.numpy()[safe].astype(np.float64)
    vals[(lap.ell_col.numpy()[safe] < 0) | ~prev_mask[:, None]] = 0
    cum = np.cumsum((vals * vals).reshape(-1))
    tol = len(cum) * 2.0 ** -24 * cum[-1]
    for i in differ:
        assert np.abs(cum - u[i] * cum[-1]).min() <= tol, f"draw {i} differs off a tie"
    return len(differ)


def same_weighted(bt, bj, mode, what=""):
    assert (bt.n_dst, bt.n_src, bt.k, bt.self_at_head) == (bj.n_dst, bj.n_src, bj.k, True)
    for name in ("dst_ids", "src_ids", "slot", "dst_mask", "src_mask"):
        a, b = getattr(bt, name).numpy(), np.asarray(getattr(bj, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")
    wt, wj = bt.weight.numpy(), np.asarray(bj.weight)
    if mode == "fastgcn":
        np.testing.assert_array_equal(wt, wj, err_msg=f"{what} weight")
    else:
        np.testing.assert_allclose(wt, wj, rtol=1e-5, atol=0, err_msg=f"{what} weight")


def _cases(n_node, seed=0):
    rng = np.random.default_rng(seed)
    train = rng.choice(n_node, BATCH, replace=False).astype(np.int32)
    masked = train.copy()
    masked[::3] = 0
    return {"train seeds": (train, np.ones(BATCH, bool)),
            "masked seeds": (masked, np.arange(BATCH) % 3 != 0)}


@pytest.mark.parametrize("mode", MODES)
def test_each_layer_equals_jax_on_its_uniforms(data, mode):
    """``_layer`` on the same destinations and JAX's uniforms, layer by layer (the
    destinations JAX's previous layer gave), on train seeds and masked seeds."""
    _, _, lt, lj = data
    ties = 0
    for ci, (name, (seeds, mask)) in enumerate(_cases(lt.n_node).items()):
        prev_ids, prev_mask = seeds, mask
        for li, s in enumerate(reversed(SIZES)):
            key = jax.random.fold_in(jax.random.key(ci), li)
            bj = jdl._layer(lj, jnp.asarray(prev_ids), jnp.asarray(prev_mask), s, key, mode)
            d = layer_draws(key, s, mode)
            bt = _layer(lt, torch.from_numpy(prev_ids), torch.from_numpy(prev_mask), s, d,
                        mode)
            n = len(prev_ids)
            drawn_t, drawn_j = bt.src_ids.numpy()[n:], np.asarray(bj.src_ids)[n:]
            if mode == "fastgcn":
                np.testing.assert_array_equal(drawn_t, drawn_j)
            else:
                layer_ties = ladies_ties(lt, prev_ids, prev_mask, d.numpy(), drawn_t, drawn_j)
                ties += layer_ties
                if layer_ties:
                    break   # the blocks differ from here on; the next case
            same_weighted(bt, bj, mode, f"{name} layer {li}")
            prev_ids, prev_mask = np.array(bj.src_ids), np.array(bj.src_mask)
    assert ties <= 1


@pytest.mark.parametrize("mode", MODES)
def test_sample_blocks_equal_jax_and_the_wrapper(data, mode):
    """The whole multi-layer sample on JAX's uniforms, and the object wrapper; a seed
    of degree 0 (an isolated node added to the graph) keeps only its self slot."""
    gt, _, lt, lj = data
    key = jax.random.key(9)
    seeds, mask = _cases(lt.n_node, 1)["masked seeds"]
    _, out_j, bj = jdl.sample_blocks_device_layerwise(lj, jnp.asarray(seeds),
                                                      jnp.asarray(mask), SIZES, key, mode)
    inp, out_t, bt = DeviceLayerWiseSampler(SIZES, mode).sample(
        lt, seeds, seed_mask=torch.from_numpy(mask), draws=batch_draws(key, mode))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    assert torch.equal(inp, bt[0].src_ids) and len(bt) == len(bj) == 2
    for li, (t, j) in enumerate(zip(bt, bj)):
        same_weighted(t, j, mode, f"block {li}")
    assert (bt[-1].weight.numpy()[~mask] == 0).all()
    # a node of degree 0: the Laplacian's self loop is its one ELL entry
    g0 = synthetic_classification_graph(**GRAPH)
    iso = g0.n_node - 1
    keep = (g0.src != iso) & (g0.dst != iso) | (g0.src == g0.dst)
    from dgll_tpu_torch.graph import Graph
    g_iso = Graph.from_edges(g0.src[keep].numpy(), g0.dst[keep].numpy(), g0.n_node)
    lap_iso = build_device_lap(g_iso, k=32, device="cpu")
    assert (lap_iso.ell_col[iso] >= 0).sum() == 1
    _, _, b = sample_blocks_device_layerwise(
        lap_iso, torch.tensor([iso], dtype=torch.int32), torch.ones(1, dtype=torch.bool),
        SIZES, torch.Generator().manual_seed(0), mode=mode)
    w = b[-1].weight[0].numpy()
    assert b[-1].slot[0, 0] == 0 and w[0] > 0 and (w[1:] == 0).all()


@pytest.mark.parametrize("mode", MODES)
def test_single_layer_estimator_unbiased_for_exact_aggregation(data, mode):
    """E[sampled aggregation] is the exact ``L[:b] @ x`` (defensive importance
    sampling), as the JAX package's test holds it, over 400 draws from a seeded torch
    generator."""
    gt, _, lt, _ = data
    lap = build_device_lap(synthetic_classification_graph(
        n_node=120, avg_degree=6, feat_dim=8, n_class=4, seed=3), k=32, device="cpu")
    L = normalized_laplacian(synthetic_classification_graph(
        n_node=120, avg_degree=6, feat_dim=8, n_class=4, seed=3)).toarray()
    x = np.random.default_rng(0).standard_normal((120, 8)).astype(np.float32)
    b, s = 16, 64
    seeds, mask = torch.arange(b, dtype=torch.int32), torch.ones(b, dtype=torch.bool)
    gen = torch.Generator().manual_seed(0)
    xt = torch.from_numpy(x)
    est = 0
    for _ in range(400):
        _, _, (blk,) = sample_blocks_device_layerwise(lap, seeds, mask, [s], gen, mode=mode)
        rows = xt[blk.src_ids.long()][blk.slot.reshape(-1).long()].reshape(b, blk.k, -1)
        est = est + torch.einsum("nk,nkf->nf", blk.weight, rows).numpy()
    expected = L[:b] @ x
    err = np.abs(est / 400 - expected).max() / max(np.abs(expected).max(), 1e-6)
    assert err < 0.12, f"{mode}: relative estimator error {err:.3f}"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


def jax_epoch_draws(key, n_batches, mode) -> EpochDraws:
    """The permutation and uniforms of the JAX runner's epoch for ``key``."""
    kperm, k = jax.random.split(key)
    order = np.asarray(jax.random.permutation(kperm, n_batches * BATCH))
    per_batch = []
    for _ in range(n_batches):
        k, ks, _ = jax.random.split(k, 3)
        per_batch.append(batch_draws(ks, mode))
    uniforms = []
    for li in range(len(SIZES)):
        layer = [b[li] for b in per_batch]
        if mode == "fastgcn":
            uniforms.append(tuple(torch.stack([b[j] for b in layer]) for j in (0, 1)))
        else:
            uniforms.append(torch.stack(layer))
    return EpochDraws(torch.from_numpy(order.astype(np.int64)), uniforms)


def runners(data, mode):
    gt, gj, lt, lj = data
    mj, mt = JaxGCN(hidden=16, n_class=4, dropout=0.0), GCN(16, 16, 4, dropout=0.0)
    rj = JaxRunner(mj, optax.adam(1e-2), lj, SIZES, BATCH, gj.get_train_nodes(), seed=0,
                   sampler=mode)
    state_j = rj.init_state(jnp.asarray(gj.node_feat))
    mt.load_state_dict(params_from_flax(_np(state_j.params)))
    rt = DeviceEpochRunner(mt, functools.partial(torch.optim.Adam, lr=1e-2), lt, SIZES,
                           BATCH, gt.get_train_nodes(), sampler=mode)
    return rj, state_j, rt, rt.init_state(gt.node_feat)


@pytest.mark.parametrize("mode", MODES)
def test_two_epochs_match_jax(data, mode):
    gt, gj, _, _ = data
    rj, state_j, rt, state_t = runners(data, mode)
    assert rt.n_batches == rj.n_batches > 5 and not rt.cuda_graph
    feats_j, labels_j = jnp.asarray(gj.node_feat), jnp.asarray(gj.labels)
    for _ in range(2):
        key = jax.random.split(rj.rng)[1]   # the key run_epoch draws next
        draws = jax_epoch_draws(key, rj.n_batches, mode)
        state_j, loss_j = rj.run_epoch(state_j, feats_j, labels_j)
        state_t, loss_t = rt.run_epoch(state_t, gt.node_feat, gt.labels, draws=draws)
        _close(float(loss_t), float(loss_j), 1e-4, "epoch loss")
    got = dict(state_t.model.named_parameters())
    want = params_from_flax(_np(state_j.params))
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k].detach(), v, 1e-5, k)


@pytest.mark.parametrize("mode", MODES)
def test_runner_draws_eval_sweep_and_exact_inference(data, mode):
    """The runner's own draws have the layer-wise shapes and make the epoch a
    function of its seed; the eval sweep is deterministic given its seed; exact
    inference equals the JAX package's with the same parameters."""
    gt, gj, lt, _ = data
    d = draw_epoch(3, BATCH, SIZES, False, torch.Generator().manual_seed(0), "cpu", mode)
    shapes = [tuple(t.shape for t in u) if isinstance(u, tuple) else u.shape
              for u in d.uniforms]
    assert shapes == ([((3, 24), (3, 24)), ((3, 48), (3, 48))] if mode == "fastgcn"
                      else [(3, 24), (3, 48)])
    losses = []
    for seed in (0, 0, 1):
        rt = DeviceEpochRunner(GCN(16, 16, 4, generator=torch.Generator().manual_seed(0)),
                               functools.partial(torch.optim.Adam, lr=1e-2), lt, SIZES,
                               BATCH, gt.get_train_nodes(), seed=seed, sampler=mode)
        state = rt.init_state()
        losses.append(float(rt.run_epoch(state, gt.node_feat, gt.labels)[1]))
    assert losses[0] == losses[1] != losses[2] and np.isfinite(losses).all()
    nodes = gt.get_validation_nodes()
    a = rt.predict_nodes(state, gt.node_feat, nodes, seed=5)
    np.testing.assert_array_equal(a, rt.predict_nodes(state, gt.node_feat, nodes, seed=5))
    assert a.shape == (len(nodes),)
    mj = JaxGCN(hidden=16, n_class=4)
    params = jax.tree.map(jnp.asarray, {
        f"GCNConv_{i}": {"weight": {"kernel": c.linear.weight.detach().numpy().T},
                         "bias": c.bias.detach().numpy()}
        for i, c in enumerate(state.model.convs)})
    gjd = jax.tree.map(jnp.asarray, gj)
    want = jax_exact_predict(mj.apply, params, gjd, gjd.node_feat)
    np.testing.assert_array_equal(rt.predict_nodes_exact(state, gt, gt.node_feat, nodes),
                                  want[nodes])


def test_make_sample_fn_takes_the_layerwise_samplers(data):
    _, _, lt, _ = data
    seeds, mask = torch.arange(BATCH, dtype=torch.int32), torch.ones(BATCH, dtype=torch.bool)
    for mode in MODES:
        inp, out, blocks = make_sample_fn(SIZES, sampler=mode)(
            lt, seeds, mask, torch.Generator().manual_seed(0))
        assert [b.n_dst for b in blocks] == [BATCH + 24, BATCH]
        assert inp.shape == (BATCH + 24 + 48,) and torch.equal(out, seeds)
    with pytest.raises(ValueError, match="unknown device sampler"):
        make_sample_fn(SIZES, sampler="graphsaint")
    with pytest.raises(ValueError, match="unknown layer-wise mode"):
        DeviceLayerWiseSampler(SIZES, "uniform")
