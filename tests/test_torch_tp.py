"""Parity of the port's tensor parallelism (``dgll_tpu_torch/parallel/tp.py``) with the
JAX package's, in two ranks over gloo on the CPU (``tests/_torch_halo_child.py``,
which imports no JAX) against the JAX functions on a 2-device ``model`` mesh.

``make_feature_sharded_spmm`` with weights and with unit weights (``weight=None``):
each rank's columns within 1e-5 x max|ref| of JAX's (float32 sums in another order);
``init_tp_gcn_params``: each rank's slices equal to JAX's arrays, sliced;
``make_tp_gcn_apply``'s log-probs on every rank within 1e-5 x max|ref| of JAX's; the
gradient of a masked NLL loss in each rank's ``w1`` columns, ``w2`` rows and ``b2``
within 1e-5 x max|ref| of ``jax.grad`` of the same loss on JAX's forward, the loss
within 1e-6, relative. ``tp_params_from_numpy`` cuts the slices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgll_tpu.parallel import make_mesh as jax_make_mesh
from dgll_tpu.parallel import tp as jtp
from dgll_tpu.train.metrics import masked_nll_loss as jax_masked_nll
from dgll_tpu_torch.nn import tp_params_from_numpy
from dgll_tpu_torch.parallel.mesh import Mesh
from test_torch_dp import data  # noqa: F401 (fixture)
from test_torch_halo import D, close, run_ranks

HIDDEN = 32
SEED = 3


def _mesh():
    return jax_make_mesh(("model",), devices=jax.devices()[:D])


def _edges(gj):
    e = gj.n_real_edge
    return (np.asarray(gj.src)[:e], np.asarray(gj.dst)[:e],
            np.asarray(gj.edge_weight)[:e], gj.n_real_node)


def test_tp_params_from_numpy_cuts_each_ranks_slices():
    rng = np.random.default_rng(0)
    full = {"w1": rng.normal(size=(6, 8)), "w2": rng.normal(size=(8, 3)),
            "b2": rng.normal(size=3)}
    parts = [tp_params_from_numpy(full, Mesh(("model",), 4, r)) for r in range(4)]
    np.testing.assert_array_equal(np.concatenate([p["w1"] for p in parts], 1),
                                  full["w1"].astype(np.float32))
    np.testing.assert_array_equal(np.concatenate([p["w2"] for p in parts], 0),
                                  full["w2"].astype(np.float32))
    for p in parts:
        np.testing.assert_array_equal(p["b2"], full["b2"].astype(np.float32))
    with pytest.raises(ValueError, match="split"):
        tp_params_from_numpy(full, Mesh(("model",), 3, 0))


def test_tp_in_two_ranks_matches_jax(data, tmp_path):
    _, gj = data
    src, dst, w, n = _edges(gj)
    mesh = _mesh()
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(n, 8)).astype(np.float32)
    x = np.asarray(gj.node_feat)[:n]
    labels = np.asarray(gj.labels)[:n]
    mask = np.asarray(gj.train_mask)[:n]
    weighted = np.asarray(jtp.make_feature_sharded_spmm(mesh, src, dst, w, n)(
        jtp.shard_features(mesh, jnp.asarray(xs))))
    unit = np.asarray(jtp.make_feature_sharded_spmm(mesh, src, dst, None, n)(
        jtp.shard_features(mesh, jnp.asarray(xs))))
    n_class = int(labels.max()) + 1
    params = jtp.init_tp_gcn_params(mesh, x.shape[1], HIDDEN, n_class, seed=SEED)
    apply = jtp.make_tp_gcn_apply(mesh, src, dst, w, n)
    logp = np.asarray(jax.jit(apply)(params, jnp.asarray(x)))

    def loss_of(p):
        return jax_masked_nll(apply(p, jnp.asarray(x)), jnp.asarray(labels),
                              jnp.asarray(mask))

    loss, grads = jax.value_and_grad(loss_of)(params)
    full = {k: np.asarray(v) for k, v in params.items()}
    inputs = {"src": src, "dst": dst, "w": w, "n": n, "xs": xs, "x": x, "labels": labels,
              "mask": mask, "seed": SEED, **full}
    ranks = run_ranks("tp", inputs, tmp_path)
    k_f, k_h = xs.shape[1] // D, HIDDEN // D
    for r, got in enumerate(ranks):
        cols, hid = slice(r * k_f, (r + 1) * k_f), slice(r * k_h, (r + 1) * k_h)
        close(f"rank {r} weighted", got["weighted"], weighted[:, cols])
        close(f"rank {r} unit weights", got["unit"], unit[:, cols])
        np.testing.assert_array_equal(got["init_w1"], full["w1"][:, hid])
        np.testing.assert_array_equal(got["init_w2"], full["w2"][hid])
        np.testing.assert_array_equal(got["init_b2"], full["b2"])
        close(f"rank {r} log-probs", got["logp"], logp)
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-6)
        close(f"rank {r} dw1", got["dw1"], np.asarray(grads["w1"])[:, hid])
        close(f"rank {r} dw2", got["dw2"], np.asarray(grads["w2"])[hid])
        close(f"rank {r} db2", got["db2"], np.asarray(grads["b2"]))
