"""Parity of the port's device-DP epoch and graph-partition path with the JAX
package's, in two ranks over gloo on the CPU (``tests/_torch_dp_child.py``).

``DeviceDPEpochRunner``: one epoch on the JAX runner's permutation and each rank's
uniforms of JAX's key chain (``split(key)`` into the permutation's and the scan's
keys, ``split(k, 3)`` a batch, ``fold_in(ks, rank)``, then ``fold_in(., layer)``,
and in window mode ``split`` into the anchors' and the slots' keys), GraphSAGE with
dropout 0, per-slot and block-window draws: every train seed is drawn exactly once
across the ranks; the step's gradient is the sum of the ranks' (JAX's epoch sums
them: ``test_jax_device_dp_gradients_are_the_sum_over_devices``), its loss the
mean; with SGD the epoch's loss within 1e-6, relative, and the parameters within
1e-5 x max|ref|; with Adam within 1e-5 and 1e-4 (its first steps
turn a near-zero gradient's rounding into a parameter difference; see
``test_torch_dp.py``). The ranks' parameters are bitwise equal.

The graph-partition path, on ``partition_graph``'s contiguous and BFS shards:
``make_sharded_spmm``'s forward and its gradient (the all-gather's transpose, summed
over the ranks) within 1e-5 x max|ref| of the JAX function's on the 2-device mesh;
a 2-layer GCN's log-probabilities within 1e-5; 3 steps of
``make_gp_gcn_train_step`` (the loss the mean over all shards' train nodes), losses
within 1e-6 relative and parameters within 1e-5 x max|ref| with SGD, 1e-5 and 1e-4
with Adam.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from dgll_tpu.nn import GraphSAGE as JaxGraphSAGE
from dgll_tpu.parallel import make_gp_gcn_train_step as jax_gp_step
from dgll_tpu.parallel import make_mesh as jax_make_mesh
from dgll_tpu.parallel import make_sharded_spmm as jax_sharded_spmm
from dgll_tpu.parallel import partition_graph as jax_partition_graph
from dgll_tpu.parallel import shard_partitioned_graph as jax_shard
from dgll_tpu.sampling import device_sampler as jds
from dgll_tpu.train import DeviceDPEpochRunner as JaxDPRunner
from dgll_tpu_torch.nn import params_from_flax
from dgll_tpu_torch.sampling.device_sampler import layer_sizes
from test_torch_dp import D, GRAPH, data, graph_inputs, run_ranks  # noqa: F401 (fixture)

FANOUTS = [4, 3]
BATCH = 16  # per device
# optimizer -> (optax's, its name and rate for the child, parameter bar, loss bar)
OPTIMIZERS = {"sgd": (optax.sgd(0.05), 0.05, 1e-5, 1e-6),
              "adam": (optax.adam(1e-2), 1e-2, 1e-4, 1e-5)}


def _mesh():
    return jax_make_mesh(("data",), devices=jax.devices()[:D])


def _layer_draws(key, n, fanout, window):
    if window:
        ka, kl = jax.random.split(key)
        return (np.asarray(jax.random.uniform(ka, (n,))),
                np.asarray(jax.random.uniform(kl, (n, fanout))))
    return np.asarray(jax.random.uniform(key, (n, fanout)))


def jax_dp_draws(key, n_batches, window) -> dict:
    """The permutation and each rank's uniforms of ``make_device_dp_epoch_fn``'s
    epoch for ``key``, as the child's inputs (``u<rank>_<layer>[_<j>]``)."""
    kperm, k = jax.random.split(key)
    out = {"order": np.asarray(jax.random.permutation(kperm, n_batches * D * BATCH))
           .astype(np.int64)}
    sizes = list(zip(layer_sizes(BATCH, FANOUTS), reversed(FANOUTS)))
    per_batch = []
    for _ in range(n_batches):
        k, ks, _ = jax.random.split(k, 3)
        per_batch.append([[_layer_draws(jax.random.fold_in(jax.random.fold_in(ks, r), li),
                                        n, f, window) for li, (n, f) in enumerate(sizes)]
                          for r in range(D)])
    for r in range(D):
        for li in range(len(FANOUTS)):
            layer = [b[r][li] for b in per_batch]
            if window:
                for j in (0, 1):
                    out[f"u{r}_{li}_{j}"] = np.stack([t[j] for t in layer])
            else:
                out[f"u{r}_{li}"] = np.stack(layer)
    return out


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("window", [False, True], ids=["per_slot", "window"])
def test_device_dp_epoch_in_two_ranks_matches_jax(data, tmp_path, window, opt):
    gt, gj = data
    tx, lr, tol, loss_tol = OPTIMIZERS[opt]
    mj = JaxGraphSAGE(hidden=16, n_class=4, dropout=0.0)
    rj = JaxDPRunner(mj, tx, jds.DeviceCSR.from_graph(gj), FANOUTS, BATCH,
                     gj.get_train_nodes(), _mesh(), seed=0, window=window)
    state = rj.init_state(jnp.asarray(gj.node_feat))
    p0 = params_from_flax(jax.tree.map(np.asarray, state.params))
    key = jax.random.split(rj.rng)[1]   # the key run_epoch draws next
    draws = jax_dp_draws(key, rj.n_batches, window)
    state, loss = rj.run_epoch(state, jnp.asarray(gj.node_feat), jnp.asarray(gj.labels))
    want = params_from_flax(jax.tree.map(np.asarray, state.params))
    inputs = {**graph_inputs(), "fanouts": np.array(FANOUTS), "batch": BATCH,
              "hidden": 16, "window": window, "opt": opt, "lr": lr, **draws,
              **{f"p:{k}": v.numpy() for k, v in p0.items()}}
    ranks = run_ranks("device_epoch", inputs, tmp_path)
    drawn = []
    for got in ranks:
        assert int(got["n_batches"]) == rj.n_batches >= 3
        drawn.append(got["seeds"][got["mask"]])
        np.testing.assert_allclose(got["loss"], float(loss), rtol=loss_tol)
        for k, v in want.items():
            v = v.numpy()
            np.testing.assert_allclose(got[f"p:{k}"], v, rtol=0, atol=tol * np.abs(v).max(),
                                       err_msg=k)
    drawn = np.concatenate(drawn)
    assert len(drawn) == len(np.unique(drawn))
    np.testing.assert_array_equal(np.sort(drawn), np.sort(gt.get_train_nodes()))
    for k in ranks[0]:
        if k.startswith("p:"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], k)


def test_jax_device_dp_gradients_are_the_sum_over_devices():
    """Why the port's device-DP epoch sums the ranks' gradients: inside a
    ``shard_map`` that checks replication (``make_device_dp_epoch_fn``'s) the
    gradient of a replicated parameter is already summed over the devices, and the
    ``pmean`` that follows leaves the sum."""
    x = jnp.arange(6.0).reshape(D, 3)

    @functools.partial(shard_map, mesh=_mesh(), in_specs=(P(), P("data")), out_specs=P())
    def grads(w, x_local):
        g = jax.grad(lambda w: (w * x_local[0]).sum())(w)
        return jax.lax.pmean(g, "data")

    np.testing.assert_array_equal(np.asarray(grads(jnp.ones(3), x)), np.asarray(x.sum(0)))


def _two_layer(p, spmm, x, rng=None):
    h = jax.nn.relu(spmm(x @ p["w1"]))
    return jax.nn.log_softmax(spmm(h @ p["w2"]))


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("strategy", ["contiguous", "bfs"])
def test_gp_spmm_and_steps_in_two_ranks_match_jax(data, tmp_path, strategy, opt):
    _, gj = data
    tx, lr, tol, loss_tol = OPTIMIZERS[opt]
    mesh = _mesh()
    pg = jax_partition_graph(gj, D, strategy=strategy)
    pgs = jax_shard(pg, mesh)
    spmm = jax_sharded_spmm(mesh, pgs)
    rng = np.random.default_rng(7)
    cot = rng.normal(size=pg.node_feat.shape).astype(np.float32)
    out, vjp = jax.vjp(spmm, pgs.node_feat)
    (dx,) = vjp(jnp.asarray(cot))
    w1 = rng.normal(0, 0.1, (GRAPH["feat_dim"], 32)).astype(np.float32)
    w2 = rng.normal(0, 0.1, (32, GRAPH["n_class"])).astype(np.float32)
    params = {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)}
    logits = _two_layer(params, spmm, pgs.node_feat)
    step, _, _ = jax_gp_step(mesh, pgs, _two_layer, tx)
    opt_state = tx.init(params)
    losses = []
    for k in range(3):
        params, opt_state, loss = step(params, opt_state, pgs.node_feat, pgs.labels,
                                       pgs.train_mask, jax.random.key(k))
        losses.append(float(loss))
    inputs = {**graph_inputs(), "strategy": strategy, "cot": cot, "w1": w1, "w2": w2,
              "steps": 3, "opt": opt, "lr": lr}
    ranks = run_ranks("gp", inputs, tmp_path)

    def close(name, got, want, bar=1e-5):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0, atol=bar * np.abs(want).max(),
                                   err_msg=name)

    close("out", np.concatenate([r["out"] for r in ranks]), out)
    close("dx", np.concatenate([r["dx"] for r in ranks]), dx)
    close("logits", np.concatenate([r["logits"] for r in ranks]), logits)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=loss_tol)
        close("w1", r["w1"], params["w1"], tol)
        close("w2", r["w2"], params["w2"], tol)
    np.testing.assert_array_equal(ranks[0]["w1"], ranks[1]["w1"])
