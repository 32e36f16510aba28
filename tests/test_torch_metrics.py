"""Parity of the port's last metrics, ``fused_gcn_layer`` and the feature transforms
with the JAX package's, on the same numpy inputs from a seed.

Tolerances: the metrics (float64 on both sides) within 1e-12; ``masked_bce_loss`` and
its gradient within 1e-6 (float32); ``fused_gcn_layer``'s output and gradients within
1e-5 (float32, the scatter's order); ``precompute_neighbor_features`` and
``row_normalize_features`` within 1e-6 (float32 sums in another order than numpy's);
``row_normalize_adj`` exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu import pad_graph as jax_pad_graph
from dgll_tpu.data import synthetic_classification_graph as jax_synthetic
from dgll_tpu.data import transforms as jax_transforms
from dgll_tpu.ops.spmm import fused_gcn_layer as jax_fused_gcn_layer
from dgll_tpu.train import metrics as jax_metrics
from dgll_tpu_torch import pad_graph
from dgll_tpu_torch.data import (
    precompute_neighbor_features,
    row_normalize_adj,
    row_normalize_features,
    synthetic_classification_graph,
)
from dgll_tpu_torch.ops import fused_gcn_layer
from dgll_tpu_torch.train import macro_f1, masked_bce_loss, roc_auc

GRAPH = dict(n_node=300, avg_degree=5, n_class=4, feat_dim=16, power_law=1.0, seed=1)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


# ------------------------------------------------------------------- metrics

@pytest.mark.parametrize("case", ["logits", "labels", "masked", "absent classes"])
def test_macro_f1_matches_jax(case):
    rng = np.random.default_rng(0)
    n, c = 80, 5
    pred = rng.normal(size=(n, c)).astype(np.float32) if case == "logits" else \
        rng.integers(0, c, n)
    target = rng.integers(0, c, n)
    mask = rng.random(n) < 0.6 if case == "masked" else None
    if case == "absent classes":  # classes 5-6 neither predicted nor present: F1 0
        c = 7
    got = macro_f1(pred, target, c, mask)
    want = jax_metrics.macro_f1(pred, target, c, mask)
    assert abs(got - want) < 1e-12 and 0 <= got <= 1
    assert macro_f1(torch.from_numpy(np.asarray(pred)), torch.from_numpy(target), c,
                    None if mask is None else torch.from_numpy(mask)) == got


@pytest.mark.parametrize("case", ["distinct", "ties", "masked", "one class",
                                  "labels beyond 1"])
def test_roc_auc_matches_jax(case):
    rng = np.random.default_rng(1)
    n = 60
    scores = rng.normal(size=n)
    target = rng.integers(0, 2, n)
    mask = None
    if case == "ties":  # few distinct scores: ties across and within classes
        scores = rng.integers(0, 4, n).astype(np.float32)
    elif case == "masked":
        mask = rng.random(n) < 0.5
    elif case == "one class":
        target = np.ones(n, np.int64)
    elif case == "labels beyond 1":  # anything but 1 is negative
        target = rng.integers(0, 3, n)
    got = roc_auc(scores, target, mask)
    want = jax_metrics.roc_auc(scores, target, mask)
    assert abs(got - want) < 1e-12
    if case == "one class":
        assert got == 0.5
    # a perfect ranking and its reverse
    assert roc_auc([0.1, 0.2, 0.9, 0.8], [0, 0, 1, 1]) == 1.0
    assert roc_auc([0.9, 0.8, 0.1, 0.2], [0, 0, 1, 1]) == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_masked_bce_loss_and_its_gradient_match_jax(masked):
    rng = np.random.default_rng(2)
    logits = (rng.normal(size=(40, 6)) * 20).astype(np.float32)  # past the clip too
    targets = (rng.random((40, 6)) < 0.4).astype(np.float32)
    mask = (rng.random(40) < 0.5) if masked else None
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = masked_bce_loss(lt, torch.from_numpy(targets),
                          None if mask is None else torch.from_numpy(mask))
    got.backward()

    def f(z):
        return jax_metrics.masked_bce_loss(z, jnp.asarray(targets),
                                           None if mask is None else jnp.asarray(mask))

    want, grad = jax.value_and_grad(f)(jnp.asarray(logits))
    _close(got.detach(), want, 1e-6, "loss")
    _close(lt.grad, grad, 1e-6, "gradient")
    assert (np.abs(logits) > 30).any() and (lt.grad.numpy()[np.abs(logits) > 30] == 0).all()


# ------------------------------------------------------------ fused_gcn_layer

@pytest.mark.parametrize("weighted", [True, False])
def test_fused_gcn_layer_and_its_gradients_match_jax(weighted):
    """Duplicated edges, a row without in-edges, and a ReLU that cuts about half the
    outputs: the backward masks the cotangent as both packages do."""
    rng = np.random.default_rng(3)
    n_src, n_dst, e, f_in, f_out = 30, 20, 120, 8, 6
    src = np.concatenate([rng.integers(0, n_src, e), [4, 4]]).astype(np.int32)
    dst = np.concatenate([rng.integers(1, n_dst, e), [7, 7]]).astype(np.int32)
    w_e = rng.random(e + 2).astype(np.float32) if weighted else None
    x = rng.normal(size=(n_src, f_in)).astype(np.float32)
    w = rng.normal(size=(f_in, f_out)).astype(np.float32)
    cot = rng.normal(size=(n_dst, f_out)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = fused_gcn_layer(torch.from_numpy(src), torch.from_numpy(dst),
                          None if w_e is None else torch.from_numpy(w_e), xt, wt, n_dst)
    (out * torch.from_numpy(cot)).sum().backward()

    ew = None if w_e is None else jnp.asarray(w_e)

    def f(xx, ww):
        return (jax_fused_gcn_layer(jnp.asarray(src), jnp.asarray(dst), ew, xx, ww, n_dst)
                * cot).sum()

    want = jax_fused_gcn_layer(jnp.asarray(src), jnp.asarray(dst), ew, jnp.asarray(x),
                               jnp.asarray(w), n_dst)
    gx, gw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    _close(out.detach(), want, 1e-5, "out")
    _close(xt.grad, gx, 1e-5, "grad x")
    _close(wt.grad, gw, 1e-5, "grad w")
    assert not out[0].any()  # no in-edge
    assert 0.2 < (out.detach() > 0).float().mean() < 0.8


# ---------------------------------------------------------------- transforms

@pytest.fixture(scope="module")
def graphs():
    """The synthetic graph on both sides, and its padded form (padded nodes and
    edges that the transforms must leave out)."""
    gt, gj = synthetic_classification_graph(**GRAPH), jax_synthetic(**GRAPH)
    return {"plain": (gt, gj),
            "padded": (pad_graph(gt, node_multiple=64, edge_multiple=256),
                       jax_pad_graph(gj, node_multiple=64, edge_multiple=256))}


@pytest.mark.parametrize("which", ["plain", "padded"])
@pytest.mark.parametrize("kind", ["mean", "sum"])
def test_precompute_neighbor_features_matches_jax(graphs, which, kind):
    gt, gj = graphs[which]
    got = precompute_neighbor_features(gt, kind)
    want = jax_transforms.precompute_neighbor_features(gj, kind)
    assert got.shape == want.shape == (gt.n_real_node, 16) and got.dtype == torch.float32
    _close(got, want, 1e-6)
    with pytest.raises(ValueError, match="unknown aggregation"):
        precompute_neighbor_features(gt, "max")
    with pytest.raises(ValueError, match="unknown aggregation"):
        jax_transforms.precompute_neighbor_features(gj, "max")


@pytest.mark.parametrize("which", ["plain", "padded"])
def test_row_normalize_adj_matches_jax(graphs, which):
    gt, gj = graphs[which]
    got = row_normalize_adj(gt)
    want = jax_transforms.row_normalize_adj(gj)
    np.testing.assert_array_equal(got.edge_weight.numpy(), np.asarray(want.edge_weight))
    assert got.edge_weight.device == gt.src.device
    assert (got.edge_weight[gt.n_real_edge:] == 0).all()


def test_row_normalize_features_matches_jax():
    x = np.random.default_rng(4).random((25, 7)).astype(np.float32)
    x[3] = 0.0  # a zero row stays zero
    got = row_normalize_features(x)
    _close(got, jax_transforms.row_normalize_features(x), 1e-6)
    assert got.dtype == torch.float32 and not got[3].any()
    np.testing.assert_array_equal(row_normalize_features(torch.from_numpy(x)).numpy(),
                                  got.numpy())
