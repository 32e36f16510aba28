"""Parity of the port's GCN with the JAX package's, from the same parameters.

A flax ``GCN`` is initialised, its parameters are carried across with
``params_from_flax``, and both models run on the same 200-node synthetic graph, with
and without the SpMM kernel layouts attached. On the JAX side the layout sends the
128-wide hidden layer through the Pallas kernel (interpret mode) and the 3-wide
output layer through ``spmm_coo``; on the port's side both layers take the kernel
wrapper, which runs its plain version on CPU tensors.

Tolerance: 1e-4 on log-probs and on parameter gradients (f32, summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu.data import gcn_normalize as jax_gcn_normalize
from dgll_tpu.data import synthetic_classification_graph as jax_synthetic
from dgll_tpu.nn import GCN as JaxGCN
from dgll_tpu.train.metrics import masked_nll_loss as jax_nll
from dgll_tpu_torch.data import gcn_normalize, synthetic_classification_graph
from dgll_tpu_torch.nn import GCN, params_from_flax
from dgll_tpu_torch.train import masked_nll_loss

TOL = dict(rtol=1e-4, atol=1e-4)
GRAPH = dict(n_node=200, avg_degree=4, n_class=3, feat_dim=16, power_law=1.0, seed=7)


def _pair(chunked: bool):
    """(jax graph on device, port graph, flax model, flax params, port model)."""
    gj = jax_gcn_normalize(jax_synthetic(**GRAPH))
    gt = gcn_normalize(synthetic_classification_graph(**GRAPH))
    if chunked:
        gj, gt = gj.with_chunked(eb=128), gt.with_chunked()
    gj = jax.tree.map(jnp.asarray, gj)
    mj = JaxGCN(hidden=128, n_class=3, dropout=0.0)
    params = mj.init(jax.random.key(0), gj, gj.node_feat)["params"]
    mt = GCN(GRAPH["feat_dim"], hidden=128, n_class=3, dropout=0.0)
    mt.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return gj, gt, mj, params, mt


@pytest.mark.parametrize("chunked", [False, True])
def test_gcn_log_probs_match(chunked):
    gj, gt, mj, params, mt = _pair(chunked)
    want = mj.apply({"params": params}, gj, gj.node_feat)
    mt.eval()
    with torch.no_grad():
        got = mt(gt, gt.node_feat)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("chunked", [False, True])
def test_gcn_gradients_match(chunked):
    gj, gt, mj, params, mt = _pair(chunked)

    def loss_of(p):
        return jax_nll(mj.apply({"params": p}, gj, gj.node_feat), gj.labels, gj.train_mask)

    lj, gradj = jax.value_and_grad(loss_of)(params)
    mt.eval()
    loss = masked_nll_loss(mt(gt, gt.node_feat), gt.labels, gt.train_mask)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lj), **TOL)
    for i in range(2):
        conv = mt.convs[i]
        gl = gradj[f"GCNConv_{i}"]
        np.testing.assert_allclose(conv.linear.weight.grad.numpy().T,
                                   np.asarray(gl["weight"]["kernel"]), **TOL)
        np.testing.assert_allclose(conv.bias.grad.numpy(), np.asarray(gl["bias"]), **TOL)


@pytest.mark.parametrize("chunked", [False, True])
def test_gcn_bf16_compute_matches(chunked):
    """``dtype=bfloat16`` computes the transform and the aggregation in bf16 with
    f32 parameters, as flax's ``dtype`` does. The frameworks round at other places,
    so the bound is bf16's: atol 5e-2 on log-probs of magnitude ~1."""
    gj, gt, _, params, _ = _pair(chunked)
    mj = JaxGCN(hidden=128, n_class=3, dropout=0.0, dtype=jnp.bfloat16)
    want = np.asarray(mj.apply({"params": params}, gj, gj.node_feat), np.float32)
    mt = GCN(GRAPH["feat_dim"], hidden=128, n_class=3, dropout=0.0, dtype=torch.bfloat16)
    mt.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    mt.eval()
    with torch.no_grad():
        got = mt(gt, gt.node_feat)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=5e-2)


def test_params_from_flax_layout():
    _, _, _, params, mt = _pair(False)
    state = params_from_flax(jax.tree.map(np.asarray, params))
    assert set(state) == set(mt.state_dict())
    assert state["convs.0.linear.weight"].shape == (128, GRAPH["feat_dim"])
    np.testing.assert_array_equal(state["convs.1.linear.weight"].numpy(),
                                  np.asarray(params["GCNConv_1"]["weight"]["kernel"]).T)
    with pytest.raises(ValueError, match="GCN"):
        params_from_flax({"Dense_0": {}})


def test_init_matches_flax_statistics():
    """LeCun normal as flax draws it: truncated at 2 std, variance 1/fan_in, biases 0.
    The numbers differ (torch vs JAX generators), so the moments are compared."""
    m = GCN(256, hidden=512, n_class=8, generator=torch.Generator().manual_seed(0))
    w = m.convs[0].linear.weight.detach().numpy()
    # flax's Dense kernel init (flax.linen.linear.default_kernel_init)
    kj = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.key(0), (256, 512)))
    for a in (w, kj):
        np.testing.assert_allclose(a.var(), 1 / 256, rtol=0.02)
        assert np.abs(a).max() <= 2 * np.sqrt(1 / 256) / 0.87962566 + 1e-6
    assert (m.convs[0].bias == 0).all()
    m2 = GCN(256, hidden=512, n_class=8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(m2.convs[0].linear.weight, m.convs[0].linear.weight)


def test_dropout_uses_generator():
    gt = gcn_normalize(synthetic_classification_graph(**GRAPH))
    m = GCN(GRAPH["feat_dim"], hidden=32, n_class=3, dropout=0.5,
            generator=torch.Generator().manual_seed(0))
    m.train()
    a = m(gt, gt.node_feat, generator=torch.Generator().manual_seed(1))
    b = m(gt, gt.node_feat, generator=torch.Generator().manual_seed(1))
    c = m(gt, gt.node_feat, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    m.eval()
    assert torch.equal(m(gt, gt.node_feat), m(gt, gt.node_feat))
