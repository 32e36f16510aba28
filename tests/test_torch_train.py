"""Parity of the port's full-batch trainer and CLI with the JAX package's.

From the same parameters and with dropout 0, the port's ``FullBatchTrainer`` with
``torch.optim.Adam``/``AdamW`` follows ``optax.adam``/``adamw`` step for step.
Tolerances: 1e-5 on the parameters after one step, 1e-4 on the losses over five
(f32, summation order).
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
from dgll_tpu.run import main as jax_main
from dgll_tpu.train.trainer import FullBatchTrainer as JaxTrainer
from dgll_tpu.train.trainer import TrainState as JaxTrainState
from dgll_tpu_torch import run as torch_run
from dgll_tpu_torch.data import gcn_normalize, synthetic_classification_graph
from dgll_tpu_torch.nn import GCN, params_from_flax
from dgll_tpu_torch.train import FullBatchTrainer, create_train_state

GRAPH = dict(n_node=200, avg_degree=4, n_class=3, feat_dim=16, power_law=1.0, seed=7)
OPTIMIZERS = {
    "adam": (optax.adam(1e-2), functools.partial(torch.optim.Adam, lr=1e-2)),
    "adamw": (optax.adamw(1e-2, weight_decay=5e-2),
              functools.partial(torch.optim.AdamW, lr=1e-2, weight_decay=5e-2)),
}


def _fit_both(opt_name, epochs):
    tx, opt = OPTIMIZERS[opt_name]
    gj = jax.tree.map(jnp.asarray, jax_gcn_normalize(jax_synthetic(**GRAPH)).with_chunked(eb=128))
    gt = gcn_normalize(synthetic_classification_graph(**GRAPH)).with_chunked()
    mj = JaxGCN(hidden=128, n_class=3, dropout=0.0)
    params = mj.init(jax.random.key(0), gj, gj.node_feat)["params"]
    state_j = JaxTrainState.create(apply_fn=mj.apply, params=params, tx=tx)
    state_j, hist_j = JaxTrainer(mj, tx).fit(
        gj, gj.node_feat, gj.labels, gj.train_mask, epochs=epochs, state=state_j)

    mt = GCN(GRAPH["feat_dim"], hidden=128, n_class=3, dropout=0.0)
    mt.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    state_t, hist_t = FullBatchTrainer(mt, opt, device="cpu").fit(
        gt, gt.node_feat, gt.labels, gt.train_mask, epochs=epochs,
        state=create_train_state(mt, opt))
    return state_j, hist_j, state_t, hist_t


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_one_step_matches_optax(opt_name):
    state_j, _, state_t, _ = _fit_both(opt_name, epochs=1)
    want = params_from_flax(jax.tree.map(np.asarray, state_j.params))
    got = state_t.model.state_dict()
    assert state_t.step == 1
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("opt_name", sorted(OPTIMIZERS))
def test_five_step_losses_match(opt_name):
    _, hist_j, _, hist_t = _fit_both(opt_name, epochs=5)
    lj = [e.loss for e in hist_j.epochs]
    lt = [e.loss for e in hist_t.epochs]
    assert len(lt) == 5 and lt[-1] < lt[0]
    np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-4)


def test_fit_validation_and_early_stop():
    g = gcn_normalize(synthetic_classification_graph(**GRAPH))
    m = GCN(GRAPH["feat_dim"], hidden=32, n_class=3, dropout=0.5,
            generator=torch.Generator().manual_seed(0))
    tr = FullBatchTrainer(m, functools.partial(torch.optim.Adam, lr=1e-2), seed=0,
                          device="cpu")
    _, hist = tr.fit(g, g.node_feat, g.labels, g.train_mask, g.val_mask,
                     epochs=50, patience=2)
    assert 2 < len(hist.epochs) <= 50
    assert hist.best_val == max(e.val_metric for e in hist.epochs)
    assert set(hist.best_params) == set(m.state_dict())
    assert all(isinstance(e.loss, float) for e in hist.epochs)


def test_cli_prints_the_jax_cli_keys(capsys):
    args = ["--samp_type", "full", "--n_node", "2000", "--n_epochs", "3"]
    want = jax_main(args)
    got = torch_run.main(args + ["--device", "cpu"])
    assert set(got) == set(want) == {"config", "trials", "aggregate"}
    # the port's flags: --device, and GCNII's --alpha and --lamda
    assert set(got["config"]) == set(want["config"]) | {"device", "alpha", "lamda"}
    # the port adds the loss curve and step times to each trial
    assert set(got["trials"][0]) == set(want["trials"][0]) | {"epoch_loss", "epoch_s"}
    assert set(got["aggregate"]) == set(want["aggregate"])
    trial = got["trials"][0]
    assert trial["epochs"] == 3 and len(trial["epoch_loss"]) == 3
    assert trial["test_acc"] > 1 / 16
