"""Parity of the port's host layer-wise samplers (FastGCN, LADIES, their flat and WRS
variants) and the normalised Laplacian with the JAX package's, and of the layers on
their ``SparseBlock``s.

The samplers are numpy and scipy in the same order in both packages, so one
``default_rng(seed)`` gives the same blocks: the Laplacian and every block field are
compared exactly, batch after batch, including ``include_seeds=False`` and a block
truncated to its heaviest edges. The layers on a ``SparseBlock`` (GCN, GraphSAGE,
GAT) match the JAX layers within 1e-5 (float32 sums in another order). The CLI's
host and device layer-wise branches print the JAX CLI's JSON keys.

The reference caveat (ROADMAP Queue 3): GraphSAGE's mean and GAT's softmax read a
layer-wise block through its COO view, so both packages count a padded
``SparseBlock`` edge (``0 -> 0``, weight 0) and an invalid ``WeightedBlock`` slot
(slot 0, weight 0) as an edge; GCN and GIN are unaffected, the weight 0 cancelling
the edge. ``test_padded_edges_count_in_sage_and_gat_in_both_packages`` shows it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu.data import synthetic_classification_graph as jax_synthetic
from dgll_tpu.nn.conv import GATConv as JaxGATConv
from dgll_tpu.nn.conv import GCNConv as JaxGCNConv
from dgll_tpu.nn.conv import GINConv as JaxGINConv
from dgll_tpu.nn.conv import SAGEConv as JaxSAGEConv
from dgll_tpu.run import main as jax_main
from dgll_tpu.sampling import FastGCNSampler as JaxFastGCN
from dgll_tpu.sampling import LadiesSampler as JaxLadies
from dgll_tpu.sampling import geometric_layer_sizes as jax_sizes
from dgll_tpu.sampling import normalized_laplacian as jax_laplacian
from dgll_tpu.sampling.base import SparseBlock as JaxSparseBlock
from dgll_tpu.sampling.base import WeightedBlock as JaxWeightedBlock
from dgll_tpu_torch import run as torch_run
from dgll_tpu_torch.data import synthetic_classification_graph
from dgll_tpu_torch.dataloader import DataLoader
from dgll_tpu_torch.nn import GATConv, GCNConv, GINConv, SAGEConv, params_from_flax
from dgll_tpu_torch.sampling import (
    FastGCNSampler,
    HostGraph,
    LadiesSampler,
    SparseBlock,
    WeightedBlock,
    geometric_layer_sizes,
    normalized_laplacian,
)
from test_torch_edge_ops import _thread_pool  # noqa: F401 (fixture)

GRAPH = dict(n_node=300, avg_degree=6, n_class=4, feat_dim=8, power_law=1.0, seed=3)
SIZES = [48, 24]
BATCH = 20


@pytest.fixture(scope="module")
def laps():
    gt, gj = synthetic_classification_graph(**GRAPH), jax_synthetic(**GRAPH)
    return gt, normalized_laplacian(gt), jax_laplacian(gj)


def test_normalized_laplacian_equals_jax(laps):
    _, lt, lj = laps
    assert lt.shape == lj.shape and lt.dtype == lj.dtype
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(lt, name), getattr(lj, name), err_msg=name)


@pytest.mark.parametrize("n, rate, layers", [(512, 1.0, 2), (64, 2.0, 3), (10, 0.5, 4)])
def test_geometric_layer_sizes_equal_jax(n, rate, layers):
    assert geometric_layer_sizes(n, rate, layers) == jax_sizes(n, rate, layers)


def same_sparse_blocks(bt, bj):
    assert len(bt) == len(bj)
    for t, j in zip(bt, bj):
        assert isinstance(t, SparseBlock)
        assert (t.n_dst, t.n_src, t.n_edge, t.self_at_head) == \
            (j.n_dst, j.n_src, j.n_edge, j.self_at_head)
        for name in ("dst_ids", "src_ids", "src", "dst", "edge_weight", "dst_mask",
                     "src_mask"):
            a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


SAMPLERS = {"fastgcn": (FastGCNSampler, JaxFastGCN), "ladies": (LadiesSampler, JaxLadies)}
VARIANTS = [dict(), dict(flatten=True), dict(wrs=True), dict(flatten=True, wrs=True),
            dict(include_seeds=False), dict(edges_per_dst=2)]


@pytest.mark.parametrize("variant", VARIANTS,
                         ids=["plain", "flat", "wrs", "flat_wrs", "no_seeds", "truncated"])
@pytest.mark.parametrize("mode", ["fastgcn", "ladies"])
def test_host_blocks_equal_jax(laps, mode, variant):
    _, lt, lj = laps
    ct, cj = SAMPLERS[mode]
    st = ct(lt, SIZES, seed=7, **variant)
    sj = cj(lj, SIZES, seed=7, **variant)
    rng = np.random.default_rng(0)
    truncated = False
    for pad_to in (None, BATCH + 5, BATCH):
        seeds = rng.choice(lt.shape[0], BATCH, replace=False)
        it, ot, bt = st.sample(None, seeds, pad_to=pad_to)
        ij, oj, bj = sj.sample(None, seeds, pad_to=pad_to)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(ot, oj)
        same_sparse_blocks(bt, bj)
        truncated |= any(int((b.edge_weight != 0).sum()) == b.n_edge for b in bt)
    assert truncated == ("edges_per_dst" in variant)


def test_loader_moves_sparse_blocks(laps):
    """``DataLoader`` with a layer-wise sampler: the blocks of the JAX loader, moved
    by ``SparseBlock.to`` to the loader's device."""
    from dgll_tpu.dataloader import DataLoader as JaxDataLoader

    gt, lt, lj = laps
    gj = jax_synthetic(**GRAPH)
    seeds = gt.get_train_nodes()
    lt_loader = DataLoader(gt, seeds, FastGCNSampler(lt, SIZES, seed=1), 8, seed=2,
                           device="cpu")
    lj_loader = JaxDataLoader(gj, seeds, JaxFastGCN(lj, SIZES, seed=1), 8, seed=2)
    n = 0
    for (it, ot, bt), (ij, oj, bj) in zip(lt_loader, lj_loader):
        np.testing.assert_array_equal(it, ij)
        same_sparse_blocks(bt, bj)
        assert all(b.src.device.type == "cpu" for b in bt)
        n += 1
    assert n == len(lt_loader) == len(lj_loader) > 1


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=1e-5, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1.0), err_msg=what)


def _layer_pair(name, in_f, jblock, x):
    """A JAX layer, its parameters on ``jblock``, and the port's layer loaded with
    them."""
    mj, mt = {
        "GCN": (JaxGCNConv(6), GCNConv(in_f, 6)),
        "SAGE": (JaxSAGEConv(6), SAGEConv(in_f, 6)),
        "GAT": (JaxGATConv(3, num_heads=2), GATConv(in_f, 3, 2)),
        "GIN": (JaxGINConv(6, learn_eps=True), GINConv(in_f, 6, learn_eps=True)),
    }[name]
    params = mj.init(jax.random.key(0), jblock, jnp.asarray(x))["params"]
    kind = type(mj).__name__
    state = params_from_flax({f"{kind}_0": _np(params)})
    mt.load_state_dict({k.removeprefix("convs.0."): v for k, v in state.items()})
    return mj, params, mt


def _blocks(laps, mode="ladies"):
    _, lt, lj = laps
    ct, cj = SAMPLERS[mode]
    seeds = np.arange(BATCH) * 7
    _, _, bt = ct(lt, SIZES, seed=3).sample(None, seeds, pad_to=BATCH + 4)
    _, _, bj = cj(lj, SIZES, seed=3).sample(None, seeds, pad_to=BATCH + 4)
    return bt, bj


@pytest.mark.parametrize("name", ["GCN", "SAGE", "GAT", "GIN"])
def test_layers_on_sparse_blocks_match_jax_with_gradients(laps, name):
    bt, bj = _blocks(laps)
    b_t, b_j = bt[-1], bj[-1]
    x = np.random.default_rng(1).normal(size=(b_t.n_src, 5)).astype(np.float32)
    mj, params, mt = _layer_pair(name, 5, b_j, x)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = mt(b_t, xt)
    cot = np.random.default_rng(2).normal(size=tuple(out.shape)).astype(np.float32)
    (out * torch.from_numpy(cot)).sum().backward()
    want = mj.apply({"params": params}, b_j, jnp.asarray(x))
    gp, gx = jax.grad(lambda p, v: (mj.apply({"params": p}, b_j, v) * cot).sum(),
                      argnums=(0, 1))(params, jnp.asarray(x))
    _close(out.detach(), want, what="out")
    _close(xt.grad, gx, what="dx")
    kind = type(mj).__name__
    want_grads = {k.removeprefix("convs.0."): v
                  for k, v in params_from_flax({f"{kind}_0": _np(gp)}).items()}
    for k, p in mt.named_parameters():
        _close(p.grad, want_grads[k], what=k)


def test_self_feature_layers_refuse_blocks_without_seeds(laps):
    _, lt, _ = laps
    _, _, bt = FastGCNSampler(lt, SIZES, include_seeds=False).sample(None, np.arange(8))
    x = torch.zeros(bt[-1].n_src, 5)
    assert GCNConv(5, 3)(bt[-1], x).shape == (8, 3)
    for layer in (SAGEConv(5, 3), GATConv(5, 3), GINConv(5, 3)):
        with pytest.raises(ValueError, match="include_seeds=False"):
            layer(bt[-1], x)


def _padded_pair():
    """One destination with two real in-edges and two padded edges (0 -> 0, weight
    0) as a SparseBlock, and as a WeightedBlock with two invalid slots; and both
    with the padding left out."""
    ids = np.array([0, 1, 2], np.int32)
    mask = np.ones(3, bool)

    def sparse(src, dst, w):
        kw = dict(dst_ids=ids[:1], src_ids=ids, src=np.asarray(src, np.int32),
                  dst=np.asarray(dst, np.int32), edge_weight=np.asarray(w, np.float32),
                  dst_mask=mask[:1], src_mask=mask, n_dst=1, n_src=3, n_edge=len(src))
        return (SparseBlock(**{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                               else v for k, v in kw.items()}),
                JaxSparseBlock(**{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                                  else v for k, v in kw.items()}))

    def weighted(slot, w):
        kw = dict(dst_ids=ids[:1], src_ids=ids, slot=np.asarray([slot], np.int32),
                  weight=np.asarray([w], np.float32), dst_mask=mask[:1], src_mask=mask,
                  n_dst=1, n_src=3, k=len(slot))
        return (WeightedBlock(**{k: torch.from_numpy(v) if isinstance(v, np.ndarray)
                                 else v for k, v in kw.items()}),
                JaxWeightedBlock(**{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                                    else v for k, v in kw.items()}))

    return {"sparse": (sparse([1, 2, 0, 0], [0, 0, 0, 0], [0.5, 0.25, 0, 0]),
                       sparse([1, 2], [0, 0], [0.5, 0.25])),
            "weighted": (weighted([1, 2, 0, 0], [0.5, 0.25, 0, 0]),
                         weighted([1, 2], [0.5, 0.25]))}


@pytest.mark.parametrize("kind", ["sparse", "weighted"])
def test_padded_edges_count_in_sage_and_gat_in_both_packages(kind):
    (padded, real) = _padded_pair()[kind]
    x = np.random.default_rng(3).normal(size=(3, 4)).astype(np.float32)
    for name in ("GCN", "SAGE", "GAT", "GIN"):
        mj, params, mt = _layer_pair(name, 4, padded[1], x)
        got = {k: mt(b[0], torch.from_numpy(x)).detach().numpy() for k, b in
               (("padded", padded), ("real", real))}
        want = {k: np.asarray(mj.apply({"params": params}, b[1], jnp.asarray(x)))
                for k, b in (("padded", padded), ("real", real))}
        for k in got:   # the port follows the JAX package on both blocks
            _close(got[k], want[k], what=f"{name} {k}")
        counted = not np.allclose(want["padded"], want["real"], rtol=1e-6, atol=1e-6)
        assert counted == (name in ("SAGE", "GAT")), name


CLI = ["--n_node", "600", "--n_epochs", "3", "--batch_size", "64", "--nhid", "16",
       "--feat_dim", "16", "--n_stops", "0", "--n_samp", "128"]


@pytest.mark.parametrize("args", [
    ["--samp_type", "fastgcn"],
    ["--samp_type", "ladies", "--exact_eval"],
    ["--samp_type", "fastgcn", "--flatten", "--wrs", "--Model", "GraphSAGE"],
    ["--samp_type", "fastgcn", "--device_sampling"],
    ["--samp_type", "ladies", "--device_sampling", "--exact_eval"],
    ["--samp_type", "fastgcn", "--device_sampling", "--flatten", "--wrs"],
])
def test_cli_layerwise_branches_print_the_jax_cli_keys(args):
    want = jax_main(CLI + args)
    got = torch_run.main(CLI + args + ["--device", "cpu"])
    assert set(got) == set(want) == {"config", "trials", "aggregate"}
    # the port's flags: --device, and GCNII's --alpha and --lamda
    assert set(got["config"]) == set(want["config"]) | {"device", "alpha", "lamda"}
    assert set(got["trials"][0]) == set(want["trials"][0]) | {"epoch_loss", "epoch_s"}
    assert set(got["aggregate"]) == set(want["aggregate"])
    trial = got["trials"][0]
    assert trial["epochs"] == 3 and all(np.isfinite(trial["epoch_loss"]))
    assert 0 <= trial["test_acc"] <= 1
    for key in ("device_sampling", "exact_eval"):
        if key in want["trials"][0]:
            assert trial[key] == want["trials"][0][key] == (f"--{key}" in args), key


def test_cli_layerwise_host_sampler_is_the_jax_clis():
    """``build_sampler``: the JAX CLI's sampler, drawing the same blocks."""
    from dgll_tpu.run import build_sampler as jax_build_sampler
    from dgll_tpu.utils import parse_train_config as jax_parse
    from dgll_tpu_torch.utils import parse_train_config

    args = ["--samp_type", "ladies", "--n_samp", "32", "--samp_growth_rate", "2",
            "--n_layers", "3", "--flatten"]
    gt, gj = synthetic_classification_graph(**GRAPH), jax_synthetic(**GRAPH)
    st = torch_run.build_sampler(parse_train_config(args), gt)
    sj = jax_build_sampler(jax_parse(args), gj)
    assert st.layer_sizes == sj.layer_sizes == [128, 64, 32] and st.flatten
    seeds = np.arange(16)
    same_sparse_blocks(st.sample(HostGraph.from_graph(gt), seeds, pad_to=16)[2],
                       sj.sample(None, seeds, pad_to=16)[2])
