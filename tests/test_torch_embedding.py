"""Parity of the port's graph embeddings (``dgll_tpu_torch/embedding``) with the JAX
package's, on the CPU.

Walks are host numpy (and the host library, whose C++ source the port copies): for
the same seed ``WalkGraph``'s arrays, ``deepwalk_walks``, ``node2vec_walks`` and
``struc2vec_walks`` equal JAX's bit for bit, with the library and with its numpy
fallbacks (both packages' ``get_lib`` returning None), and so do ``walk_pairs``. The
native wrappers against their fallbacks: ``sort_rows`` equal; the library's walks and
the fallback's (other generators) both follow out-edges, a node without one repeating.

Skip-gram: the port's ``SkipGramModel`` starts from JAX's tables
(``skipgram_from_jax``) and takes 3 steps on JAX's own negatives (the test replays
``jax.random.split`` of the model's key and ``randint``, as JAX's ``train`` draws
them): the losses and ``w_out`` within 1e-5 x max|ref| (Adam on float32 sums in
another order), ``w_in`` within 2e-4 x max|ref| and no further from the same steps in
float64 than JAX's is (its reason at ``W_IN_TOL``). ``train`` takes the batches in
JAX's order (the same ``default_rng(seed)`` permutation). Classifiers: ``train_classifier`` (every kind) and
``train_all_classifiers`` equal JAX's, with sklearn and with sklearn blocked (the
softmax-regression fallback, which is what runs where sklearn is not installed).
``DeepWalk``, ``Node2Vec`` and ``Struc2Vec`` walk as JAX's do and train; without a
card they refuse the default device.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgll_tpu.embedding as jemb
from dgll_tpu import native as jnative
from dgll_tpu.data import synthetic_classification_graph as jax_synthetic
from dgll_tpu.embedding import skipgram as jskipgram
from dgll_tpu_torch import embedding as temb
from dgll_tpu_torch import native as tnative
from dgll_tpu_torch.data import synthetic_classification_graph
from dgll_tpu_torch.nn import skipgram_from_jax

GRAPH = dict(n_node=120, avg_degree=6, n_class=3, feat_dim=8, homophily=0.9, seed=0)
TOL = 1e-5  # x max|ref|


@pytest.fixture(scope="module")
def graphs():
    gt, gj = synthetic_classification_graph(**GRAPH), jax_synthetic(**GRAPH)
    np.testing.assert_array_equal(gt.src.numpy(), np.asarray(gj.src))
    np.testing.assert_array_equal(gt.dst.numpy(), np.asarray(gj.dst))
    return gt, gj


@pytest.fixture(params=["native", "fallback"])
def path(request, monkeypatch):
    """The walks with the host library, or with both packages' numpy fallbacks."""
    if request.param == "native":
        assert tnative.native_available() and jnative.native_available()
    else:
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
        monkeypatch.setattr(jnative, "get_lib", lambda: None)
    return request.param


def _walk_graphs(graphs):
    gt, gj = graphs
    return temb.WalkGraph.from_graph(gt), jemb.WalkGraph.from_graph(gj)


def test_walk_graph_equals_jax(graphs, path):
    wt, wj = _walk_graphs(graphs)
    assert wt.n_node == wj.n_node
    for f in ("indptr", "nbrs", "degrees"):
        np.testing.assert_array_equal(getattr(wt, f), getattr(wj, f), f)


def test_deepwalk_walks_equal_jax(graphs, path):
    wt, wj = _walk_graphs(graphs)
    got = temb.deepwalk_walks(wt, 3, 12, seed=4)
    np.testing.assert_array_equal(got, jemb.deepwalk_walks(wj, 3, 12, seed=4))
    starts = np.arange(0, wt.n_node, 7)
    np.testing.assert_array_equal(temb.deepwalk_walks(wt, 2, 5, seed=1, nodes=starts),
                                  jemb.deepwalk_walks(wj, 2, 5, seed=1, nodes=starts))


@pytest.mark.parametrize("p,q", [(1.0, 1.0), (0.5, 2.0), (4.0, 0.25)])
def test_node2vec_walks_equal_jax(graphs, path, p, q):
    wt, wj = _walk_graphs(graphs)
    np.testing.assert_array_equal(temb.node2vec_walks(wt, 2, 10, p, q, seed=2),
                                  jemb.node2vec_walks(wj, 2, 10, p, q, seed=2))


def test_struc2vec_walks_equal_jax():
    kw = dict(n_node=40, avg_degree=4, n_class=2, feat_dim=4, seed=1)
    wt = temb.WalkGraph.from_graph(synthetic_classification_graph(**kw))
    wj = jemb.WalkGraph.from_graph(jax_synthetic(**kw))
    for args in ((2, 8), (1, 6)):
        np.testing.assert_array_equal(
            temb.struc2vec_walks(wt, *args, k_hops=1, n_similar=5, seed=3),
            jemb.struc2vec_walks(wj, *args, k_hops=1, n_similar=5, seed=3))
    np.testing.assert_array_equal(temb.struc2vec_walks(wt, 1, 5, seed=0),
                                  jemb.struc2vec_walks(wj, 1, 5, seed=0))


def test_walk_pairs_equal_jax(graphs):
    wt, _ = _walk_graphs(graphs)
    walks = temb.deepwalk_walks(wt, 2, 9, seed=0)
    for window in (1, 3, 5):
        np.testing.assert_array_equal(
            temb.walk_pairs(walks, window, np.random.default_rng(window)),
            jemb.walk_pairs(walks, window, np.random.default_rng(window)))


def _follows_edges(wg, walks):
    u, v = walks[:, :-1].ravel(), walks[:, 1:].ravel()
    deg = wg.degrees[u]
    assert (v[deg == 0] == u[deg == 0]).all()
    for a, b in zip(u[deg > 0], v[deg > 0]):
        assert b in wg.nbrs[wg.indptr[a]:wg.indptr[a + 1]], (a, b)


def test_native_wrappers_against_their_fallbacks(graphs, monkeypatch):
    wt, _ = _walk_graphs(graphs)
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 1000, len(wt.nbrs))
    native_sorted = tnative.sort_rows(wt.indptr, vals)
    starts = np.arange(wt.n_node)
    native_walks = tnative.random_walks(wt.indptr, wt.nbrs, starts, 8, 5)
    n2v = tnative.node2vec_walks_native(wt.indptr, wt.nbrs, starts, 8, 0.5, 2.0, 5)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    np.testing.assert_array_equal(tnative.sort_rows(wt.indptr, vals), native_sorted)
    assert tnative.node2vec_walks_native(wt.indptr, wt.nbrs, starts, 8, 0.5, 2.0, 5) is None
    np_walks = tnative.random_walks(wt.indptr, wt.nbrs, starts, 8, 5)
    np.testing.assert_array_equal(np_walks, tnative._np_walks(wt.indptr, wt.nbrs,
                                                              starts, 8, 5))
    for walks in (native_walks, np_walks, n2v):
        assert walks.shape == (wt.n_node, 8)
        np.testing.assert_array_equal(walks[:, 0], starts)
        _follows_edges(wt, walks)


def _jax_negatives(key, b, k, n_node):
    key, sub = jax.random.split(key)
    return key, sub, np.array(jax.random.randint(sub, (b, k), 0, n_node))


# Adam divides a gradient by its root mean square plus eps 1e-8. At step 2, w_out has
# just left 0, and some of w_in's gradients are about 1e-8, cancellations of several
# pairs' terms: their float32 rounding then moves w_in's update by up to about 1e-4 x
# max|w_in| in either package against the same steps in float64 (measured: JAX
# 1.19e-4, the port 3.6e-5, at 5 negatives). So w_in is held to 2e-4 x max|ref| of
# JAX's, and to no further from the float64 run than JAX's is (plus 1e-5 x max|ref|);
# the losses and w_out, whose gradients are not near eps, to 1e-5.
W_IN_TOL = 2e-4


@pytest.mark.parametrize("n_negative", [1, 5])
def test_skipgram_steps_on_jax_negatives_match_jax(graphs, n_negative):
    wt, _ = _walk_graphs(graphs)
    pairs = temb.walk_pairs(temb.deepwalk_walks(wt, 2, 10, seed=0), 4,
                            np.random.default_rng(0))
    jm = jskipgram.SkipGramModel(wt.n_node, 16, n_negative, lr=1e-2, seed=3)
    tables = skipgram_from_jax(jax.tree.map(np.asarray, jm.params))
    tm = temb.SkipGramModel(wt.n_node, 16, n_negative, lr=1e-2, seed=3, device="cpu")
    tm.load_state_dict(tables)
    exact = temb.SkipGramModel(wt.n_node, 16, n_negative, lr=1e-2, seed=3,
                               device="cpu").double()
    exact.load_state_dict({k: v.double() for k, v in tables.items()})
    exact.optimizer = torch.optim.Adam(exact.parameters(), lr=1e-2)
    key, bs = jm._key, 64
    for i in range(3):
        batch = pairs[i * bs:(i + 1) * bs]
        key, sub, neg = _jax_negatives(key, bs, n_negative, wt.n_node)
        jm.params, jm.opt_state, jloss = jm._step(
            jm.params, jm.opt_state, jnp.asarray(batch[:, 0], jnp.int32),
            jnp.asarray(batch[:, 1], jnp.int32), sub)
        loss = tm.step(batch[:, 0], batch[:, 1], neg)
        exact.step(batch[:, 0], batch[:, 1], neg)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    for k, bar in (("w_in", W_IN_TOL), ("w_out", TOL)):
        want = np.asarray(jm.params[k])
        got = getattr(tm, k).detach().numpy()
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=bar * scale, err_msg=k)
        ref = getattr(exact, k).detach().numpy()
        assert np.abs(got - ref).max() <= np.abs(want - ref).max() + TOL * scale, k
    np.testing.assert_array_equal(tm.embeddings, tm.w_in.detach().numpy())
    np.testing.assert_array_equal(tm.node_embedding([3, 1]), tm.embeddings[[3, 1]])
    np.testing.assert_array_equal(tm.edge_embedding([0], [2]),
                                  tm.embeddings[[0]] * tm.embeddings[[2]])


def test_skipgram_train_takes_jax_batch_order(graphs, monkeypatch):
    wt, _ = _walk_graphs(graphs)
    pairs = temb.walk_pairs(temb.deepwalk_walks(wt, 1, 6, seed=0), 2,
                            np.random.default_rng(0))
    jm = jskipgram.SkipGramModel(wt.n_node, 8, seed=0)
    tm = temb.SkipGramModel(wt.n_node, 8, seed=0, device="cpu")
    seen_j, seen_t = [], []
    jstep, tstep = jm._step, tm.step

    def record_j(params, opt, c, t, k):
        seen_j.append(np.stack([np.asarray(c), np.asarray(t)], 1))
        return jstep(params, opt, c, t, k)

    def record_t(c, t, negatives=None):
        seen_t.append(np.stack([c.numpy(), t.numpy()], 1))
        return tstep(c, t, negatives)

    jm._step = record_j
    monkeypatch.setattr(tm, "step", record_t)
    bs = len(pairs) // 3 + 1  # two full batches, the tail left out
    last = tm.train(pairs, epochs=2, batch_size=bs, seed=9)
    jm.train(pairs, epochs=2, batch_size=bs, seed=9)
    assert len(seen_t) == len(seen_j) == 4 and np.isfinite(last)
    for a, b in zip(seen_t, seen_j):
        np.testing.assert_array_equal(a, b)
    assert tm.train() is tm and tm.training  # nn.Module.train() still works


def _block_sklearn(monkeypatch):
    for name in [m for m in sys.modules if m == "sklearn" or m.startswith("sklearn.")]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "sklearn", None)


@pytest.mark.parametrize("sklearn", ["present", "blocked"])
def test_classifiers_equal_jax(monkeypatch, sklearn):
    if sklearn == "blocked":
        _block_sklearn(monkeypatch)
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 3, 90)
    emb = rng.normal(size=(90, 6)) + labels[:, None] * 0.8
    for kind in ("logistic", "tree", "forest", "boosting", "mlp"):
        acc, pred = temb.train_classifier(emb, labels, kind, seed=2)
        jacc, jpred = jemb.train_classifier(emb, labels, kind, seed=2)
        assert acc == jacc, kind
        np.testing.assert_array_equal(pred, jpred, kind)
    assert temb.train_all_classifiers(emb, labels, 1) == jemb.train_all_classifiers(
        emb, labels, 1)
    with pytest.raises(ValueError, match="unknown classifier"):
        temb.train_classifier(emb, labels, "svm")


def test_softmax_regression_equals_jax():
    from dgll_tpu.embedding.classifiers import _softmax_regression as jax_sr
    from dgll_tpu_torch.embedding.classifiers import _softmax_regression

    rng = np.random.default_rng(1)
    x, y = rng.normal(size=(50, 5)), rng.integers(0, 4, 50)
    np.testing.assert_array_equal(_softmax_regression(x[:40], y[:40], x[40:]),
                                  jax_sr(x[:40], y[:40], x[40:]))


@pytest.mark.parametrize("cls,kw", [("DeepWalk", {}), ("Node2Vec", {"p": 0.5, "q": 2.0}),
                                    ("Struc2Vec", {})])
def test_wrappers_walk_as_jax_and_train(cls, kw, monkeypatch):
    g_kw = dict(n_node=40, avg_degree=4, n_class=2, feat_dim=4, seed=1)
    common = dict(walk_length=6, num_walks=2, dim=8, seed=0)
    tm = getattr(temb, cls)(synthetic_classification_graph(**g_kw), **kw, **common,
                            device="cpu")
    jm = getattr(jemb, cls)(jax_synthetic(**g_kw), **kw, **common)
    walks = tm.walks()
    want = {"DeepWalk": lambda: jemb.deepwalk_walks(jm.wg, 2, 6, 0),
            "Node2Vec": lambda: jemb.node2vec_walks(jm.wg, 2, 6, 0.5, 2.0, 0),
            "Struc2Vec": lambda: jemb.struc2vec_walks(jm.wg, 2, 6, seed=0)}[cls]()
    np.testing.assert_array_equal(walks, want)
    np.testing.assert_array_equal(tm.model.w_in.detach().numpy().shape, (40, 8))
    assert tm.train(epochs=1) is tm and np.isfinite(tm.embeddings).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(temb, cls)(synthetic_classification_graph(**g_kw), **kw, **common)


def test_save_load_and_plot(tmp_path):
    emb = np.random.default_rng(0).normal(size=(30, 4)).astype(np.float32)
    path = str(tmp_path / "emb.npy")
    temb.save_embedding(path, emb)
    np.testing.assert_array_equal(temb.load_embedding(path), emb)
    out = temb.plot_embedding(emb, labels=np.arange(30) % 3, path=str(tmp_path / "e.png"))
    assert (tmp_path / "e.png").stat().st_size > 0 and out.endswith("e.png")
