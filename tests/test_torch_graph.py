"""Parity of the port's graph container, synthetic dataset, padding and GCN
normalisation with the JAX package's.

Edges within a CSR row may come in another order in the two packages (the JAX
package may build its CSR in native code), so rows are compared as sorted
multisets. Weights are compared exactly: both packages compute them in the same
numpy float64 arithmetic.
"""
import numpy as np
import pytest
import torch

from dgll_tpu.data import gcn_normalize as jax_gcn_normalize
from dgll_tpu.data import synthetic_classification_graph as jax_synthetic
from dgll_tpu.graph import Graph as JaxGraph
from dgll_tpu.graph import pad_graph as jax_pad_graph
from dgll_tpu_torch import Graph, pad_graph
from dgll_tpu_torch.data import gcn_normalize, synthetic_classification_graph


def _rows(g, weighted=False):
    """Per-row sorted (src[, weight]) lists, for either package's graph."""
    indptr = np.asarray(g.indptr)
    src = np.asarray(g.src)
    w = None if g.edge_weight is None else np.asarray(g.edge_weight)
    rows = []
    for i in range(len(indptr) - 1):
        lo, hi = indptr[i], indptr[i + 1]
        if weighted:
            rows.append(sorted(zip(src[lo:hi].tolist(), w[lo:hi].tolist())))
        else:
            rows.append(sorted(src[lo:hi].tolist()))
    return rows


def _assert_same_graph(gt, gj, weighted=False):
    assert (gt.n_node, gt.n_edge, gt.n_real_node, gt.n_real_edge) == (
        gj.n_node, gj.n_edge, gj.n_real_node, gj.n_real_edge)
    np.testing.assert_array_equal(gt.indptr.numpy(), np.asarray(gj.indptr))
    np.testing.assert_array_equal(gt.dst.numpy(), np.asarray(gj.dst))
    assert _rows(gt, weighted) == _rows(gj, weighted)


@pytest.mark.parametrize("power_law", [0.0, 1.0])
def test_synthetic_graph_matches(power_law):
    kw = dict(n_node=300, avg_degree=5, n_class=4, feat_dim=8,
              power_law=power_law, seed=3)
    gt, gj = synthetic_classification_graph(**kw), jax_synthetic(**kw)
    _assert_same_graph(gt, gj)
    np.testing.assert_array_equal(gt.node_feat.numpy(), np.asarray(gj.node_feat))
    np.testing.assert_array_equal(gt.labels.numpy(), np.asarray(gj.labels))
    for m in ("train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(gt, m).numpy(), np.asarray(getattr(gj, m)))


@pytest.mark.parametrize("bidir,loops", [(False, False), (True, False), (True, True)])
def test_from_edges_matches(bidir, loops):
    rng = np.random.default_rng(1)
    n, e = 50, 400
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    kw = dict(make_bidirected=bidir, add_self_loops=loops)
    gt = Graph.from_edges(src, dst, n, edge_weight=w, **kw)
    gj = JaxGraph.from_edges(src, dst, n, edge_weight=w, **kw)
    _assert_same_graph(gt, gj, weighted=True)
    assert gt.src.dtype == torch.int32 and gt.edge_weight.dtype == torch.float32


def test_pad_graph_matches():
    g_kw = dict(n_node=123, avg_degree=3, n_class=3, feat_dim=4, seed=5)
    gt = pad_graph(synthetic_classification_graph(**g_kw), 8, 128)
    gj = jax_pad_graph(jax_synthetic(**g_kw), 8, 128)
    _assert_same_graph(gt, gj)
    assert gt.n_node > gt.n_real_node and gt.n_edge > gt.n_real_edge
    np.testing.assert_array_equal(gt.node_feat.numpy(), np.asarray(gj.node_feat))
    np.testing.assert_array_equal(gt.train_mask.numpy(), np.asarray(gj.train_mask))
    # pad edges are self-loops on the last padded node
    assert (gt.src[gt.n_real_edge:] == gt.n_node - 1).all()


@pytest.mark.parametrize("pad", [False, True])
def test_gcn_normalize_matches(pad):
    g_kw = dict(n_node=200, avg_degree=4, n_class=3, feat_dim=4, power_law=1.0, seed=2)
    gt, gj = synthetic_classification_graph(**g_kw), jax_synthetic(**g_kw)
    if pad:
        gt, gj = pad_graph(gt), jax_pad_graph(gj)
    gt, gj = gcn_normalize(gt), jax_gcn_normalize(gj)
    _assert_same_graph(gt, gj, weighted=True)
    assert (gt.edge_weight[gt.n_real_edge:] == 0).all()


def test_gcn_normalize_needs_self_loops():
    g = Graph.from_edges([0, 1], [1, 2], 3)
    with pytest.raises(ValueError, match="without self-loops"):
        gcn_normalize(g)
    with pytest.raises(ValueError, match="without self-loops"):
        jax_gcn_normalize(JaxGraph.from_edges([0, 1], [1, 2], 3))


def test_graph_to_moves_layouts():
    g = gcn_normalize(synthetic_classification_graph(n_node=64, avg_degree=3,
                                                     feat_dim=4, seed=0))
    gc = g.with_chunked().to("cpu")
    assert gc.chunked.n_rows == 128 and gc.chunked_t.n_rows == 128
    assert gc.chunked.src.numel() == g.n_real_edge
    assert gc.node_feat.device.type == "cpu"
