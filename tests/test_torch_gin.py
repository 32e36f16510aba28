"""Parity of the port's GIN (``GINConv``, ``GINNode``, ``GIN``), global pooling,
``batch_graphs`` and ``synthetic_graph_classification`` with the JAX package's.

The layers and models get the JAX parameters through ``params_from_flax`` and the
same inputs: forward and gradients within 1e-5 (float32 sums in another order), on a
full ``Graph`` (the plain COO sum, and K1's plain version through the chunked
layouts), a fanout-dense ``Block``, a host ``SparseBlock`` and a device
``WeightedBlock``. Pooling drops padded nodes (``graph_id == n_graph``) explicitly
where the JAX segment ops drop them silently: sums, means and maxima within 1e-5,
gradients too. The data generator and ``batch_graphs`` are exactly equal. The CLI's
GIN branches print the JAX CLI's JSON keys.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu.data import gcn_normalize as jax_gcn_normalize
from dgll_tpu.data import synthetic_classification_graph as jax_synthetic
from dgll_tpu.data.datasets import synthetic_graph_classification as jax_graph_data
from dgll_tpu.nn import GIN as JaxGIN
from dgll_tpu.nn import GINNode as JaxGINNode
from dgll_tpu.nn import Pooling as JaxPooling
from dgll_tpu.nn import batch_graphs as jax_batch_graphs
from dgll_tpu.nn.conv import GINConv as JaxGINConv
from dgll_tpu.run import main as jax_main
from dgll_tpu.sampling import FastGCNSampler as JaxFastGCN
from dgll_tpu.sampling import HostGraph as JaxHostGraph
from dgll_tpu.sampling import NeighborSampler as JaxNeighborSampler
from dgll_tpu.sampling import build_device_lap as jax_build_lap
from dgll_tpu.sampling import normalized_laplacian as jax_laplacian
from dgll_tpu.sampling import sample_blocks_device_layerwise as jax_sample_layerwise
from dgll_tpu.train import exact_predict as jax_exact_predict
from dgll_tpu_torch import run as torch_run
from dgll_tpu_torch.data import (
    gcn_normalize,
    synthetic_classification_graph,
    synthetic_graph_classification,
)
from dgll_tpu_torch.nn import (
    GIN,
    GINConv,
    GINNode,
    Pooling,
    batch_graphs,
    max_pooling,
    params_from_flax,
)
from dgll_tpu_torch.sampling import (
    FastGCNSampler,
    HostGraph,
    NeighborSampler,
    build_device_lap,
    normalized_laplacian,
    sample_blocks_device_layerwise,
)
from dgll_tpu_torch.train import exact_predict
from test_torch_edge_ops import _thread_pool  # noqa: F401 (fixture)

GRAPH = dict(n_node=300, avg_degree=6, n_class=4, feat_dim=8, power_law=1.0, seed=3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=1e-5, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1.0), err_msg=what)


@pytest.fixture(scope="module")
def graphs():
    gt = gcn_normalize(synthetic_classification_graph(**GRAPH))
    gj = jax_gcn_normalize(jax_synthetic(**GRAPH))
    return gt, gj


def structures(graphs, kind):
    """The same message structure in both packages, and its ``n_src``."""
    gt, gj = graphs
    seeds = np.arange(0, 240, 12)
    if kind in ("graph", "graph_chunked"):
        return (gt.with_chunked() if kind == "graph_chunked" else gt,
                jax.tree.map(jnp.asarray, gj), gt.n_node)
    if kind == "block":
        _, _, bt = NeighborSampler([4, 3], seed=1).sample(HostGraph.from_graph(gt), seeds,
                                                          pad_to=24)
        _, _, bj = JaxNeighborSampler([4, 3], seed=1).sample(JaxHostGraph.from_graph(gj),
                                                             seeds, pad_to=24)
    elif kind == "sparse":
        _, _, bt = FastGCNSampler(normalized_laplacian(gt), [40, 20], seed=2).sample(
            None, seeds, pad_to=24)
        _, _, bj = JaxFastGCN(jax_laplacian(gj), [40, 20], seed=2).sample(
            None, seeds, pad_to=24)
    else:   # "weighted": the device sampler, FastGCN, on JAX's uniforms
        key = jax.random.key(3)
        mask = np.arange(24) < 20
        ids = np.zeros(24, np.int32)
        ids[:20] = seeds
        _, _, bj = jax_sample_layerwise(jax_build_lap(gj), jnp.asarray(ids),
                                        jnp.asarray(mask), [40, 20], key, "fastgcn")
        draws = []
        for li, s in enumerate((20, 40)):
            k1, k2 = jax.random.split(jax.random.fold_in(key, li))
            draws.append(tuple(torch.from_numpy(np.array(jax.random.uniform(k, (s,))))
                               for k in (k1, k2)))
        _, _, bt = sample_blocks_device_layerwise(
            build_device_lap(gt, device="cpu"), torch.from_numpy(ids),
            torch.from_numpy(mask), [40, 20], draws=draws, mode="fastgcn")
    return bt, bj, bt[0].n_src


KINDS = ["graph", "graph_chunked", "block", "sparse", "weighted"]


def _grads_close(model_t, grads_j, what):
    want = params_from_flax(_np(grads_j))
    got = dict(model_t.named_parameters())
    assert set(got) == set(want), what
    for k, p in got.items():
        _close(p.grad, want[k], what=f"{what} {k}")


@pytest.mark.parametrize("learn_eps", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_gin_conv_matches_jax_with_gradients(graphs, kind, learn_eps):
    st, sj, n_src = structures(graphs, kind)
    gt, gj = (st[-1], sj[-1]) if isinstance(st, list) else (st, sj)
    x = np.random.default_rng(1).normal(size=(gt.n_src if kind not in KINDS[:2]
                                             else n_src, 8)).astype(np.float32)
    mj = JaxGINConv(6, learn_eps=learn_eps)
    params = mj.init(jax.random.key(0), gj, jnp.asarray(x))["params"]
    if learn_eps:   # a nonzero eps, so that its gradient and use are both tested
        params = {**params, "eps": jnp.asarray(0.3, jnp.float32)}
    mt = GINConv(8, 6, learn_eps=learn_eps)
    state = params_from_flax({"GINConv_0": _np(params)})
    mt.load_state_dict({k.removeprefix("convs.0."): v for k, v in state.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mt(gt, xt)
    cot = np.random.default_rng(2).normal(size=tuple(out.shape)).astype(np.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    want = mj.apply({"params": params}, gj, jnp.asarray(x))
    gp, gx = jax.grad(lambda p, v: (mj.apply({"params": p}, gj, v) * cot).sum(),
                      argnums=(0, 1))(params, jnp.asarray(x))
    _close(out.detach(), want, what="out")
    _close(xt.grad, gx, what="dx")
    want_g = {k.removeprefix("convs.0."): v
              for k, v in params_from_flax({"GINConv_0": _np(gp)}).items()}
    assert set(want_g) == {k for k, _ in mt.named_parameters()}
    for k, p in mt.named_parameters():
        _close(p.grad, want_g[k], what=k)


@pytest.mark.parametrize("kind", KINDS)
def test_gin_node_matches_jax_with_gradients(graphs, kind):
    st, sj, n_src = structures(graphs, kind)
    x = np.random.default_rng(4).normal(size=(n_src, 8)).astype(np.float32)
    mj = JaxGINNode(hidden=16, n_class=4, learn_eps=True, dropout=0.5)
    params = mj.init(jax.random.key(1), sj, jnp.asarray(x))["params"]
    mt = GINNode(8, 16, 4, learn_eps=True, dropout=0.5)
    mt.load_state_dict(params_from_flax(_np(params)))
    mt.eval()
    out = mt(st, torch.from_numpy(x))
    cot = np.random.default_rng(5).normal(size=tuple(out.shape)).astype(np.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    want = mj.apply({"params": params}, sj, jnp.asarray(x))
    gp = jax.grad(lambda p: (mj.apply({"params": p}, sj, jnp.asarray(x)) * cot).sum())(params)
    _close(out.detach(), want, what="out")
    _grads_close(mt, gp, kind)
    mt.train()   # dropout from the generator
    a = mt(st, torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    b = mt(st, torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.isfinite(a).all()


def test_graph_classification_data_and_batching_equal_jax():
    dt = synthetic_graph_classification(n_graph=12, seed=4)
    dj = jax_graph_data(n_graph=12, seed=4)
    for t, j in zip(dt, dj):
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
    gt, gid_t, y_t = batch_graphs(dt)
    gj, gid_j, y_j = jax_batch_graphs(dj)
    assert (gt.n_node, gt.n_edge, gt.n_real_node, gt.n_real_edge) == \
        (gj.n_node, gj.n_edge, gj.n_real_node, gj.n_real_edge)
    assert gt.n_node > gt.n_real_node and (gid_t.numpy()[gt.n_real_node:] == 12).all()
    for name in ("indptr", "src", "dst", "node_feat"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(getattr(gj, name)),
                                      err_msg=name)
    assert gt.edge_weight is None and gj.edge_weight is None
    np.testing.assert_array_equal(gid_t.numpy(), np.asarray(gid_j))
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert gid_t.dtype == y_t.dtype == torch.int32


@pytest.mark.parametrize("kinds", [("sum",), ("mean",), ("max",), ("sum", "mean", "max")])
def test_pooling_drops_padded_nodes_as_jax(kinds):
    rng = np.random.default_rng(6)
    n_graph = 5
    gid = np.concatenate([np.repeat(np.arange(n_graph), [3, 1, 4, 2, 3]), [5, 5, 5]])
    gid[[4, 9]] = gid[[9, 4]]   # ids out of order
    x = rng.normal(size=(len(gid), 4)).astype(np.float32)
    x[-3:] = 100.0   # padded rows: never in any graph's sum, mean or max
    x[1] = x[0]      # a tie for graph 0's max
    xt = torch.from_numpy(x).requires_grad_(True)
    out = Pooling(kinds)(xt, torch.from_numpy(gid.astype(np.int32)), n_graph)
    pj = JaxPooling(kinds)
    want = pj.apply({}, jnp.asarray(x), jnp.asarray(gid.astype(np.int32)), n_graph)
    _close(out.detach(), want, what="pooled")
    assert out.shape == (n_graph, 4 * len(kinds)) and out.abs().max() < 50
    cot = rng.normal(size=tuple(out.shape)).astype(np.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    gx = jax.grad(lambda v: (pj.apply({}, v, jnp.asarray(gid.astype(np.int32)), n_graph)
                             * cot).sum())(jnp.asarray(x))
    _close(xt.grad, gx, what="dx")
    assert (xt.grad[-3:] == 0).all()
    # an empty graph pools to 0, as in the JAX package
    real = torch.from_numpy(gid[:-3].astype(np.int32))
    assert (max_pooling(torch.from_numpy(x[:-3]), real, n_graph + 2)[n_graph:] == 0).all()


@pytest.mark.parametrize("pooling", [("sum",), ("sum", "mean"), ("max",)])
def test_gin_graph_classifier_matches_jax_with_gradients(pooling):
    data = synthetic_graph_classification(n_graph=10, seed=2)
    gt, gid, y = batch_graphs(data)
    gj, gid_j, _ = jax_batch_graphs(jax_graph_data(n_graph=10, seed=2))
    mj = JaxGIN(hidden=8, n_class=2, n_layers=3, learn_eps=True, pooling=pooling,
                dropout=0.1)
    params = mj.init(jax.random.key(0), gj, gj.node_feat, gid_j, 10)["params"]
    mt = GIN(8, 8, 2, n_layers=3, learn_eps=True, pooling=pooling, dropout=0.1)
    mt.load_state_dict(params_from_flax(_np(params)))
    mt.eval()
    out = mt(gt, gt.node_feat, gid, 10)
    assert out.shape == (10, 2)
    nll = -out.gather(1, y.long()[:, None]).mean()
    nll.backward()
    want = mj.apply({"params": params}, gj, gj.node_feat, gid_j, 10)
    gp = jax.grad(lambda p: -jnp.take_along_axis(
        mj.apply({"params": p}, gj, gj.node_feat, gid_j, 10),
        jnp.asarray(y.numpy())[:, None], axis=-1).mean())(params)
    _close(out.detach(), want, what="logp")
    _grads_close(mt, gp, "GIN")
    mt.train()   # the readout's dropout from the generator
    a, b = (mt(gt, gt.node_feat, gid, 10, generator=torch.Generator().manual_seed(0))
            for _ in range(2))
    assert torch.equal(a, b) and torch.isfinite(a).all() and not torch.equal(a, out)


def test_gin_exact_inference_matches_jax(graphs):
    gt, gj = graphs
    mj = JaxGINNode(hidden=16, n_class=4)
    gjd = jax.tree.map(jnp.asarray, gj)
    params = mj.init(jax.random.key(2), gjd, gjd.node_feat)["params"]
    mt = GINNode(8, 16, 4)
    mt.load_state_dict(params_from_flax(_np(params)))
    np.testing.assert_array_equal(exact_predict(mt, gt, gt.node_feat),
                                  jax_exact_predict(mj.apply, params, gjd, gjd.node_feat))


CLI = ["--Model", "GIN", "--n_node", "600", "--n_epochs", "3", "--batch_size", "64",
       "--nhid", "16", "--feat_dim", "16", "--n_stops", "0"]


@pytest.mark.parametrize("args", [
    ["--samp_type", "full"],
    ["--samp_type", "neighbor"],
    ["--samp_type", "neighbor", "--exact_eval"],
    ["--device_sampling"],
    ["--samp_type", "fastgcn", "--n_samp", "128"],
])
def test_cli_gin_branches_print_the_jax_cli_keys(args):
    want = jax_main(CLI + args)
    got = torch_run.main(CLI + args + ["--device", "cpu"])
    assert set(got) == set(want) == {"config", "trials", "aggregate"}
    # the port's flags: --device, and GCNII's --alpha and --lamda
    assert set(got["config"]) == set(want["config"]) | {"device", "alpha", "lamda"}
    assert set(got["trials"][0]) == set(want["trials"][0]) | {"epoch_loss", "epoch_s"}
    assert set(got["aggregate"]) == set(want["aggregate"])
    trial = got["trials"][0]
    assert trial["epochs"] == 3 and all(np.isfinite(trial["epoch_loss"]))
    assert trial["epoch_loss"][-1] < trial["epoch_loss"][0]
    assert 0 <= trial["test_acc"] <= 1


def test_cli_attaches_gins_layouts_as_gcns():
    """On a CUDA device a GIN run takes GCN's layouts (windowed tried first)."""
    from dgll_tpu_torch.utils import parse_train_config

    g = torch_run.build_dataset(parse_train_config(["--n_node", "2000"]))
    gin, gcn = (torch_run.build_model(parse_train_config(m), 3, g.node_feat.shape[1])
                for m in (["--Model", "GIN"], []))
    gin, extra = torch_run.attach_kernel_layouts(gin, g)
    gcn, extra_gcn = torch_run.attach_kernel_layouts(gcn, g)
    assert gin.chunked is not None and (gin.hybrid is None) == (gcn.hybrid is None)
    assert extra["spmm_kernel"] == extra_gcn["spmm_kernel"]
