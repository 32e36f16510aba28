"""Parity of the port's data modules and ``Graph`` query helpers with the JAX
package's, on the CPU.

The loaders read the repo's fixtures (``tests/fixtures/planetoid``,
``tests/fixtures/ppi``) and files written into ``tmp_path``; named datasets go
through ``load_dataset`` with a mocked loader. Graphs are compared array by array,
exactly: both packages build them with numpy from the same inputs. A graph saved by
either package loads in the other. The CLI reads a saved graph and the planetoid
fixture as the JAX CLI does.
"""
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dgll_tpu.data as jdata
from dgll_tpu.graph import pad_graph as jax_pad_graph
from dgll_tpu.run import build_dataset as jax_build_dataset
from dgll_tpu.run import main as jax_main
from dgll_tpu.sampling import HostGraph as JaxHostGraph
from dgll_tpu.utils import parse_train_config as jax_parse_train_config
from dgll_tpu_torch import data as tdata
from dgll_tpu_torch import run as torch_run
from dgll_tpu_torch.graph import pad_graph
from dgll_tpu_torch.sampling.base import HostGraph
from dgll_tpu_torch.utils import parse_train_config

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
FIELDS = ("indptr", "src", "dst", "edge_weight", "node_feat", "labels", "train_mask",
          "val_mask", "test_mask")


def _np(x):
    if x is None:
        return None
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same_graph(gt, gj):
    """Every array and count of the port's graph ``gt`` equals the JAX graph's."""
    for f in FIELDS:
        a, b = _np(getattr(gt, f)), _np(getattr(gj, f))
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("n_node", "n_edge", "n_real_node", "n_real_edge"):
        assert getattr(gt, f) == getattr(gj, f), f


# -------------------------------------------------------------------- loaders

def test_load_planetoid_matches_jax():
    gt = tdata.load_planetoid(os.path.join(FIX, "planetoid"), "tiny")
    same_graph(gt, jdata.load_planetoid(os.path.join(FIX, "planetoid"), "tiny"))
    assert gt.n_real_node > 0 and torch.allclose(gt.node_feat.sum(1),
                                                 torch.ones(gt.n_node))


def test_load_ppi_split_matches_jax():
    gts = tdata.load_ppi_split(os.path.join(FIX, "ppi"), "train")
    gjs = jdata.load_ppi_split(os.path.join(FIX, "ppi"), "train")
    assert len(gts) == len(gjs) > 1
    for gt, gj in zip(gts, gjs):
        same_graph(gt, gj)
        assert gt.labels.dtype == torch.float32 and gt.labels.dim() == 2


@pytest.mark.parametrize("feat_dim", [0, 4])
def test_synthetic_power_law_graph_matches_jax(feat_dim):
    same_graph(tdata.synthetic_power_law_graph(300, 5, 1.2, seed=3, feat_dim=feat_dim),
               jdata.synthetic_power_law_graph(300, 5, 1.2, seed=3, feat_dim=feat_dim))


def _graphs_to_save():
    kw = dict(n_node=150, avg_degree=4, n_class=3, feat_dim=6, power_law=1.0, seed=2)
    return {
        "normalised": (tdata.gcn_normalize(tdata.synthetic_classification_graph(**kw)),
                       jdata.gcn_normalize(jdata.synthetic_classification_graph(**kw))),
        "unlabelled": (tdata.synthetic_power_law_graph(120, 3, seed=1),
                       jdata.synthetic_power_law_graph(120, 3, seed=1)),
    }


@pytest.mark.parametrize("kind", ["normalised", "unlabelled"])
@pytest.mark.parametrize("saver", ["jax", "port"])
def test_saved_graph_loads_in_both_packages(tmp_path, saver, kind):
    gt, gj = _graphs_to_save()[kind]
    path = str(tmp_path / f"{kind}.graph")
    if saver == "jax":
        jdata.save_graph(gj, path)
    else:
        tdata.save_graph(gt, path)
    loaded_t, loaded_j = tdata.load_graph(path), jdata.load_graph(path)
    same_graph(loaded_t, loaded_j)
    same_graph(loaded_t, gj)


_DATAP = """3
3 1
0 2 1 2
1 1 0
7 1 0
2 0
1 1 1
1 1 0
4 1
7 2 1 3
0 1 0
0 1 3
1 2 2 0
"""

_DATAP_ATTRS = """2
2 5
0 1 1 0.5 1.5
1 1 0 2.0 -1.0
3 6
1 2 1 2 0.0 0.0
0 1 0 1.0 1.0
0 1 0 3.0 2.0
"""


@pytest.mark.parametrize("text, degree_as_tag", [(_DATAP, False), (_DATAP, True),
                                                 (_DATAP_ATTRS, False)])
def test_load_dataP_matches_jax(tmp_path, text, degree_as_tag):
    path = tmp_path / "graphs.txt"
    path.write_text(text)
    gts, nt = tdata.load_dataP(str(path), degree_as_tag)
    gjs, nj = jdata.load_dataP(str(path), degree_as_tag)
    assert nt == nj and len(gts) == len(gjs)
    for a, b in zip(gts, gjs):
        for f in ("src", "dst", "node_features"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        for f in ("node_tags", "label", "n_node", "neighbors", "max_neighbor"):
            assert getattr(a, f) == getattr(b, f), f
    for ta, ja in zip(tdata.s2v_to_tuples(gts), jdata.s2v_to_tuples(gjs)):
        for x, y in zip(ta, ja):
            np.testing.assert_array_equal(x, y)


def test_load_dataP_refuses_partial_attributes(tmp_path):
    path = tmp_path / "bad.txt"
    path.write_text("1\n2 0\n0 1 1 0.5\n0 1 0\n")
    with pytest.raises(ValueError, match="all or none"):
        tdata.load_dataP(str(path))


def test_separate_graphs_and_data_match_jax(tmp_path):
    labels = np.array([0] * 40 + [1] * 20 + [2] * 40)
    for fold in (0, 3):
        for a, b in zip(tdata.separate_data(labels, 10, fold, seed=1),
                        jdata.separate_data(labels, 10, fold, seed=1)):
            np.testing.assert_array_equal(a, b)
    path = tmp_path / "graphs.txt"
    path.write_text(_DATAP)
    gts, _ = tdata.load_dataP(str(path))
    gjs, _ = jdata.load_dataP(str(path))
    for a, b in zip(tdata.separate_graphs(gts, seed=0, fold_idx=1, n_splits=2),
                    jdata.separate_graphs(gjs, seed=0, fold_idx=1, n_splits=2)):
        assert [g.label for g in a] == [g.label for g in b]
        assert [g.n_node for g in a] == [g.n_node for g in b]


# ------------------------------------------------------------------- registry

def _fake_loader():
    rng = np.random.default_rng(0)
    n, e = 50, 300
    return (rng.integers(0, n, e), rng.integers(0, n, e),
            rng.normal(size=(n, 8)).astype(np.float32), rng.integers(0, 3, n),
            {"train": np.arange(30), "valid": np.arange(30, 40), "test": np.arange(40, 50)})


def test_registry_with_mocked_loader_matches_jax():
    loader = mock.MagicMock(side_effect=_fake_loader)
    gt = tdata.load_dataset("ogbn-products", loader=loader)
    loader.assert_called_once()
    same_graph(gt, jdata.load_dataset("ogbn-products", loader=_fake_loader))
    assert gt.get_train_nodes().shape == (30,)
    assert tdata.DATASETS == jdata.DATASETS
    for name in tdata.DATASETS:
        assert tdata.dataset_metric(name) == jdata.dataset_metric(name)
    with pytest.raises(KeyError):
        tdata.load_dataset("not-a-dataset")
    with pytest.raises(RuntimeError, match="loader"):
        tdata.load_dataset("reddit")


def test_data_exports_match_jax():
    assert set(jdata.__all__) <= set(tdata.__all__)


# ---------------------------------------------------------------- data.utils

def _host_graphs():
    kw = dict(n_node=100, avg_degree=5, seed=0)
    return (HostGraph.from_graph(tdata.synthetic_classification_graph(**kw)),
            JaxHostGraph.from_graph(jdata.synthetic_classification_graph(**kw)))


def test_multihop_sampling_matches_jax():
    ht, hj = _host_graphs()
    hops = tdata.multihop_sampling(ht, np.arange(8), [3, 2], seed=4)
    assert [len(h) for h in hops] == [8, 24, 48]
    for h in hops:
        assert h.min() >= 0 and h.max() < ht.n_node
    # every sampled id of hop k is an in-neighbour of its parent in hop k-1
    for prev, cur, k in ((hops[0], hops[1], 3), (hops[1], hops[2], 2)):
        for i, v in enumerate(prev):
            nbrs = set(ht.src[ht.indptr[v]: ht.indptr[v + 1]]) or {v}
            assert set(cur[i * k: (i + 1) * k]) <= nbrs
    # the same host library and seeds: the same draws as the JAX package
    for a, b in zip(hops, jdata.multihop_sampling(hj, np.arange(8), [3, 2], seed=4)):
        np.testing.assert_array_equal(a, b)


def test_create_khop_index_matches_jax():
    ht, hj = _host_graphs()
    idx = tdata.create_khop_index(ht, k=2, max_neighbors=4, seed=1)
    assert idx.shape == (100, 4)
    np.testing.assert_array_equal(idx, jdata.create_khop_index(hj, k=2, max_neighbors=4,
                                                               seed=1))


# ------------------------------------------------------------ Graph queries

def test_graph_query_helpers_match_jax():
    kw = dict(n_node=61, avg_degree=3, n_class=4, feat_dim=5, seed=9)
    gt = pad_graph(tdata.synthetic_classification_graph(**kw))
    gj = jax_pad_graph(jdata.synthetic_classification_graph(**kw))
    assert gt.n_node > gt.n_real_node and gt.n_edge > gt.n_real_edge
    nodes = [0, 5, 17, 60]
    assert [list(map(int, n)) for n in gt.get_neighbors(nodes)] == \
        [list(map(int, n)) for n in gj.get_neighbors(nodes)]
    np.testing.assert_array_equal(gt.get_induced_subgraph(nodes + [3, 4]),
                                  gj.get_induced_subgraph(nodes + [3, 4]))
    np.testing.assert_array_equal(gt.get_features(np.array(nodes)).numpy(),
                                  np.asarray(gj.get_features(nodes)))
    np.testing.assert_array_equal(gt.get_labels(nodes).numpy(),
                                  np.asarray(gj.get_labels(nodes)))
    gjd = jax.tree.map(jnp.asarray, gj)
    for name in ("in_degrees", "edge_mask", "node_mask"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(),
                                      np.asarray(getattr(gjd, name)), err_msg=name)
    feats = np.ones((gt.n_node, 2), np.float32)
    g2 = gt.with_features(node_feat=feats)
    assert torch.equal(g2.node_feat, torch.ones(gt.n_node, 2))
    assert g2.labels is gt.labels and gt.with_features().node_feat is gt.node_feat
    g3 = gt.with_features(labels=np.zeros(gt.n_node, np.int32))
    assert g3.node_feat is gt.node_feat and int(g3.labels.sum()) == 0


# -------------------------------------------------------------------- the CLI

def _cli_args(dataset):
    return ["--Model", "GCN", "--samp_type", "full", "--dataset", dataset,
            "--n_epochs", "2", "--nhid", "8"]


@pytest.mark.parametrize("source", ["saved", "planetoid"])
def test_cli_reads_datasets_as_the_jax_cli(tmp_path, source):
    if source == "saved":
        dataset = str(tmp_path / "g.graph")
        tdata.save_graph(tdata.synthetic_classification_graph(
            n_node=400, avg_degree=4, n_class=3, feat_dim=8, seed=5), dataset)
    else:
        dataset = os.path.join(FIX, "planetoid", "tiny")
    want = jax_main(_cli_args(dataset))
    got = torch_run.main(_cli_args(dataset) + ["--device", "cpu"])
    assert set(got["trials"][0]) == set(want["trials"][0]) | {"epoch_loss", "epoch_s"}
    trial, jtrial = got["trials"][0], want["trials"][0]
    assert trial["metric_name"] == jtrial["metric_name"]
    assert trial["epochs"] == 2 and np.isfinite(trial["epoch_loss"]).all()
    same_graph(torch_run.build_dataset(parse_train_config(_cli_args(dataset))),
               jax_build_dataset(jax_parse_train_config(_cli_args(dataset))))
