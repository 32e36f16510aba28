"""Parity of the port's data-parallel pieces with the JAX package's, on the CPU.

``partition_graph`` (contiguous, bfs, range) equals the JAX package's element for
element; ``ShardedDataLoader``'s blocks equal JAX's bit for bit, stacked, and a
rank's loader yields its own sub-batch of the same step. The steps run in two ranks
over gloo (``tests/_torch_dp_child.py``, started by ``launch_local``, which imports
no JAX) against the JAX step on a 2-device virtual mesh, from the same parameters
(``params_from_flax``), GraphSAGE with dropout 0 and SGD: after 3 steps the
parameters within 1e-5 x max|ref| and each step's loss within 1e-6, relative
(float32, sums in another order); with Adam within 1e-4 and 1e-5 (see
``OPTIMIZERS``); the ranks' parameters bitwise equal. The one-step-stale step (its
gradients applied at the start of the next step, the last by the flush) matches
JAX's after its flush; under SGD it traces the synchronous step's losses, under Adam
(whose first, zero, update counts as a step) it does not. ``launch_local`` kills the
other ranks when one exits non-zero, and raises within seconds, where the JAX
package's would wait for rank 0 in order. Each multi-rank run has its own limit
(``launch_local``'s timeout, and the process group's 60 s for a collective).
"""
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from dgll_tpu.data import gcn_normalize as jax_gcn_normalize
from dgll_tpu.data import synthetic_classification_graph as jax_synthetic
from dgll_tpu.nn import GraphSAGE as JaxGraphSAGE
from dgll_tpu.parallel import ShardedDataLoader as JaxShardedLoader
from dgll_tpu.parallel import make_async_dp_block_step as jax_async_step
from dgll_tpu.parallel import make_dp_block_step as jax_dp_step
from dgll_tpu.parallel import make_mesh as jax_make_mesh
from dgll_tpu.parallel import partition_graph as jax_partition_graph
from dgll_tpu.sampling import HostGraph as JaxHostGraph
from dgll_tpu.sampling import NeighborSampler as JaxSampler
from dgll_tpu_torch.data import gcn_normalize, synthetic_classification_graph
from dgll_tpu_torch.nn import params_from_flax
from dgll_tpu_torch.parallel import ShardedDataLoader, launch_local, partition_graph
from dgll_tpu_torch.parallel.launch import RankFailed
from dgll_tpu_torch.sampling import HostGraph, NeighborSampler

CHILD = os.path.join(os.path.dirname(__file__), "_torch_dp_child.py")
GRAPH = dict(n_node=400, avg_degree=6, n_class=4, feat_dim=16, power_law=1.0, seed=0,
             train_frac=0.3)
FANOUTS = [4, 3]
BATCH = 16  # per device
D = 2
STEPS = 3
LIMIT_S = 120  # each multi-rank run's time limit


def graph_inputs():
    g = dict(GRAPH)
    return {"n_node": g["n_node"], "avg_degree": g["avg_degree"], "n_class": g["n_class"],
            "feat_dim": g["feat_dim"], "graph_seed": g["seed"],
            "train_frac": g["train_frac"]}


def run_ranks(mode, inputs, tmp_path, limit=LIMIT_S):
    """``mode`` of the child script in ``D`` ranks; each rank's outputs."""
    path = str(tmp_path / f"{mode}_in.npz")
    np.savez(path, **inputs)
    launch_local(D, [sys.executable, CHILD, mode, path, str(tmp_path)],
                 env={"OMP_NUM_THREADS": "1"}, timeout=limit)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(D)]


@pytest.fixture(scope="module")
def data():
    gt = gcn_normalize(synthetic_classification_graph(**GRAPH))
    gj = jax_gcn_normalize(jax_synthetic(**GRAPH))
    np.testing.assert_array_equal(gt.src.numpy(), np.asarray(gj.src))
    return gt, gj


@pytest.mark.parametrize("strategy", ["contiguous", "bfs", "range"])
def test_partition_graph_equals_jax(data, strategy):
    gt, gj = data
    got = partition_graph(gt, 3, strategy=strategy, seed=5)
    want = jax_partition_graph(gj, 3, strategy=strategy, seed=5)
    for f in ("src", "dst_local", "edge_weight", "node_feat", "labels", "train_mask",
              "val_mask", "test_mask", "perm"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), f)
    for f in ("n_shard", "rows_per_shard", "e_shard", "n_real_node", "n_node"):
        assert getattr(got, f) == getattr(want, f), f
    # every real edge once, with its weight
    assert np.isclose(got.edge_weight.sum(), gt.edge_weight[: gt.n_real_edge].sum().item(),
                      rtol=1e-5)


def test_partition_graph_numpy_pack_equals_native(data, monkeypatch):
    from dgll_tpu_torch import native

    gt, _ = data
    want = partition_graph(gt, 4)
    monkeypatch.setattr(native, "partition_pack", lambda *a: None)
    got = partition_graph(gt, 4)
    for f in ("src", "dst_local", "edge_weight"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


def _jax_loader(gj):
    return JaxShardedLoader(JaxHostGraph.from_graph(gj), gj.get_train_nodes(),
                            JaxSampler(FANOUTS, seed=0), BATCH, D, seed=0)


def test_sharded_loader_blocks_equal_jax(data):
    gt, gj = data
    lt = ShardedDataLoader(HostGraph.from_graph(gt), gt.get_train_nodes(),
                           NeighborSampler(FANOUTS, seed=0), BATCH, D, seed=0)
    ranks = [ShardedDataLoader(HostGraph.from_graph(gt), gt.get_train_nodes(),
                               NeighborSampler(FANOUTS, seed=0), BATCH, D, seed=0, rank=r)
             for r in range(D)]
    lj = _jax_loader(gj)
    assert len(lt) == len(lj) == len(ranks[0]) >= STEPS
    for (ot, bt), (oj, bj), *mine in zip(lt, lj, *ranks):
        np.testing.assert_array_equal(ot, oj)
        assert len(bt) == len(bj) == len(FANOUTS)
        for t, j in zip(bt, bj):
            assert (t.fanout, t.n_dst) == (int(j.fanout), int(j.n_dst))
            for f in ("dst_ids", "src_ids", "neigh_mask", "dst_mask"):
                np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
        for r, (o_r, b_r) in enumerate(mine):
            np.testing.assert_array_equal(o_r, oj[r])
            for t, j in zip(b_r, bj):
                np.testing.assert_array_equal(t.src_ids.numpy(), np.asarray(j.src_ids[r]))
                np.testing.assert_array_equal(t.neigh_mask.numpy(),
                                              np.asarray(j.neigh_mask[r]))


def _jax_model_and_params(gj):
    mj = JaxGraphSAGE(hidden=16, n_class=4, dropout=0.0)
    _, blocks = next(iter(_jax_loader(gj)))
    local = jax.tree.map(lambda a: a[0], blocks, is_leaf=lambda a: isinstance(a, jax.Array))
    params = mj.init(jax.random.key(0), local, jnp.take(gj.node_feat, local[0].src_ids, 0))
    return mj, params["params"]


def _jax_steps(gj, mj, params, asynchronous, tx):
    mesh = jax_make_mesh(("data",), devices=jax.devices()[:D])
    params = jax.tree.map(jnp.copy, params)  # the steps donate their inputs
    opt = tx.init(params)

    def model_apply(p, blocks, x, rng):
        return mj.apply({"params": p}, blocks, x, deterministic=True)

    it = iter(_jax_loader(gj))
    losses, outs = [], []
    if asynchronous:
        step, init_grads = jax_async_step(mesh, model_apply, tx)
        grads = init_grads(params)
    else:
        step = jax_dp_step(mesh, model_apply, tx)
    for k in range(STEPS):
        out, blocks = next(it)
        outs.append(out)
        x = jnp.take(gj.node_feat, blocks[0].src_ids, axis=0)
        y = jnp.take(gj.labels, blocks[-1].dst_ids, axis=0)
        args = (blocks, x, y, blocks[-1].dst_mask, jax.random.key(k))
        if asynchronous:
            params, opt, grads, loss = step(params, opt, grads, *args)
        else:
            params, opt, loss = step(params, opt, *args)
        losses.append(float(loss))
    if asynchronous:
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
    return np.array(losses), np.stack(outs), params_from_flax(jax.tree.map(np.asarray, params))


def _assert_params_close(got: dict, want: dict, tol=1e-5):
    assert {k for k in got if k.startswith("p:")} == {f"p:{k}" for k in want}
    for k, v in want.items():
        v = v.numpy()
        np.testing.assert_allclose(got[f"p:{k}"], v, rtol=0,
                                   atol=tol * np.abs(v).max(), err_msg=k)


# optimizer -> (optax's, its name and rate for the child, parameter bar, loss bar);
# Adam's first steps move a parameter by about lr * g / |g|, so the float32 rounding
# of a near-zero gradient entry becomes a parameter difference of lr times its
# relative error: its bars are the host minibatch tests' (1e-4), SGD's the ones above
OPTIMIZERS = {"sgd": (optax.sgd(0.05), 0.05, 1e-5, 1e-6),
              "adam": (optax.adam(1e-2), 1e-2, 1e-4, 1e-5)}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("asynchronous", [False, True], ids=["sync", "async"])
def test_dp_steps_in_two_ranks_match_jax(data, tmp_path, asynchronous, opt):
    _, gj = data
    tx, lr, tol, loss_tol = OPTIMIZERS[opt]
    mj, params = _jax_model_and_params(gj)
    p0 = params_from_flax(jax.tree.map(np.asarray, params))
    want_losses, want_outs, want = _jax_steps(gj, mj, params, asynchronous, tx)
    inputs = {**graph_inputs(), "fanouts": np.array(FANOUTS), "batch": BATCH,
              "hidden": 16, "steps": STEPS, "async": asynchronous, "opt": opt, "lr": lr,
              **{f"p:{k}": v.numpy() for k, v in p0.items()}}
    ranks = run_ranks("dp_step", inputs, tmp_path)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["outs"], want_outs[:, r])  # its own sub-batch
        np.testing.assert_allclose(got["losses"], want_losses, rtol=loss_tol)
        _assert_params_close(got, want, tol)
    for k in ranks[0]:
        if k.startswith("p:"):  # the ranks hold the same parameters, bit for bit
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], k)
    if asynchronous:
        # step k applies step k-1's gradients before computing its own, at the
        # parameters the synchronous step k computes them at: the same trajectory
        # under SGD; Adam counts the first, zero, update as a step, and drifts
        sync_losses, _, _ = _jax_steps(gj, mj, params, False, tx)
        assert want_losses[0] == sync_losses[0]
        assert np.allclose(ranks[0]["losses"], sync_losses, rtol=1e-6) == (opt == "sgd")


def test_launch_local_kills_the_others_when_a_rank_fails(tmp_path):
    t0 = time.perf_counter()
    with pytest.raises(RankFailed) as err:
        run_ranks("fail", {"x": np.zeros(1)}, tmp_path, limit=60)
    assert err.value.rank == 1 and err.value.returncode == 1
    assert isinstance(err.value, RuntimeError)
    # rank 0 was waiting in a barrier for rank 1: killed, not left until the timeout
    assert time.perf_counter() - t0 < 30


def test_launch_local_times_out(tmp_path):
    with pytest.raises(subprocess.TimeoutExpired):
        launch_local(2, [sys.executable, "-c", "import time; time.sleep(30)"], timeout=2)


def test_launch_smoke_all_reduces_over_the_ranks():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.run([sys.executable, "-m", "dgll_tpu_torch.parallel.launch",
                           "--n_processes", "3", "--device", "cpu"], env=env,
                          capture_output=True, text=True, timeout=LIMIT_S)
    assert proc.returncode == 0, proc.stderr
    assert "MULTIPROC_OK procs=3 backend=gloo sum=6.0" in proc.stdout
