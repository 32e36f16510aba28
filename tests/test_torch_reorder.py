"""Parity of the port's locality reordering and community detection with the JAX
package's (``dgll_tpu/parallel/reorder.py``, ``community.py``), and of the decision
``Graph.with_windowed`` takes: attach, decline, or relabel then attach.

Everything here is host numpy on both sides, so results must be equal exactly.
Community detection runs the shared C++ label propagation, which is single-threaded,
and so the same on every run, below 16,384 nodes; the graphs here stay below that.
The numpy fallback of both sides is compared too, with the library switched off.
"""
import functools
import json

import numpy as np
import pytest
import torch

import dgll_tpu.native as jax_native
from dgll_tpu.data import gcn_normalize as jax_gcn_normalize
from dgll_tpu.graph import Graph as JaxGraph
from dgll_tpu.parallel import community as jcom
from dgll_tpu.parallel import reorder as jreo
from dgll_tpu_torch import native
from dgll_tpu_torch.data import gcn_normalize
from dgll_tpu_torch.graph import Graph
from dgll_tpu_torch.parallel import community as tcom
from dgll_tpu_torch.parallel import reorder as treo


@pytest.fixture(autouse=True)
def same_label_propagation(monkeypatch):
    """Both packages run the same label propagation: the shared C++ kernel where
    both loaders built it, else (a failed or raced build) both numpy fallbacks."""
    if not (native.native_available() and jax_native.native_available()):
        monkeypatch.setattr(jax_native, "label_propagation_native", lambda *a: False)
        monkeypatch.setattr(native, "label_propagation", lambda *a: False)


def _clustered(n, deg, n_comm, intra, seed, shuffle=False):
    rng = np.random.default_rng(seed)
    e = n * deg
    dst = rng.integers(0, n, e)
    csize = n // n_comm
    src = np.where(rng.random(e) < intra, (dst // csize) * csize + rng.integers(0, csize, e),
                   rng.integers(0, n, e)) % n
    if shuffle:
        relabel = rng.permutation(n)
        src, dst = relabel[src], relabel[dst]
    return src, dst


def _uniform(n, e, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e)


# name: (n, edges). "spread" has ~40 edges per (row block, window) group with
# sources spread over the whole window: the estimate passes, the layout declines.
GRAPHS = {
    "clustered": (4096, lambda: _clustered(4096, 8, 8, 0.9, seed=1)),
    "shuffled": (8192, lambda: _clustered(8192, 3, 8, 0.95, seed=8, shuffle=True)),
    "expander": (16000, lambda: _uniform(16000, 64000, seed=2)),
    "spread": (4096, lambda: _uniform(4096, 10240, seed=3)),
}


@functools.cache
def graph_args(name):
    """Keyword arguments of ``Graph.from_edges`` for both packages: the edges, with
    self-loops, features, labels and masks."""
    n, make = GRAPHS[name]
    src, dst = make()
    rng = np.random.default_rng(4)
    return dict(src=src, dst=dst, n_node=n,
                node_feat=rng.standard_normal((n, 6)).astype(np.float32),
                labels=rng.integers(0, 5, n).astype(np.int32),
                train_mask=rng.random(n) < 0.5, val_mask=rng.random(n) < 0.2,
                test_mask=rng.random(n) < 0.3, add_self_loops=True)


def graphs(name, normalize=True):
    gj = JaxGraph.from_edges(**graph_args(name))
    gt = Graph.from_edges(**graph_args(name))
    if normalize:
        gj, gt = jax_gcn_normalize(gj), gcn_normalize(gt)
    return gj, gt


def assert_same_graph(gj, gt):
    for f in ("indptr", "src", "dst", "edge_weight", "node_feat", "labels",
              "train_mask", "val_mask", "test_mask", "node_perm"):
        a, b = getattr(gj, f), getattr(gt, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
    for f in ("n_node", "n_edge", "n_real_node", "n_real_edge"):
        assert getattr(gj, f) == getattr(gt, f), f


@pytest.mark.parametrize("min_fill", [0.25, 0.5])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_estimate_windowed_fraction_equal(name, min_fill):
    gj, gt = graphs(name, normalize=False)
    want = jreo.estimate_windowed_fraction(np.asarray(gj.src), np.asarray(gj.dst), min_fill)
    assert treo.estimate_windowed_fraction(gt.src.numpy(), gt.dst.numpy(), min_fill) == want


@pytest.mark.parametrize("name", ["clustered", "shuffled"])
def test_degree_and_rcm_orders_equal(name):
    gj, gt = graphs(name, normalize=False)
    np.testing.assert_array_equal(gt.out_degrees_np(), gj.out_degrees_np())
    np.testing.assert_array_equal(treo.degree_order(gt), jreo.degree_order(gj))
    np.testing.assert_array_equal(treo.rcm_order(gt), jreo.rcm_order(gj))


@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("name", ["clustered", "shuffled"])
def test_communities_equal(monkeypatch, name, fallback):
    """Label propagation through the C++ kernel on both sides, or, with the library
    switched off on both, through the numpy fallback; then the community order."""
    if fallback:
        monkeypatch.setattr(jax_native, "label_propagation_native", lambda *a: False)
        monkeypatch.setattr(native, "label_propagation", lambda *a: False)
    gj, gt = graphs(name, normalize=False)
    part = tcom.detect_communities(gt, seed=3)
    np.testing.assert_array_equal(part, jcom.detect_communities(gj, seed=3))
    assert 1 < part.max() + 1 < gt.n_node
    np.testing.assert_array_equal(treo.community_order(gt, seed=3),
                                  jreo.community_order(gj, seed=3))


@pytest.mark.parametrize("min_size,max_size", [(1, 7), (40, 300), (700, 50)])
def test_merge_and_split_equal(min_size, max_size):
    rng = np.random.default_rng(min_size)
    part = rng.integers(0, 200, 3000) ** 2 % 997  # skewed community sizes
    np.testing.assert_array_equal(tcom.merge_groups(part, min_size),
                                  jcom.merge_groups(part, min_size))
    np.testing.assert_array_equal(tcom.split_oversized(part, max_size),
                                  jcom.split_oversized(part, max_size))
    assert tcom.max_community_size(1 << 20, 64) == jcom.max_community_size(1 << 20, 64)


def test_permute_graph_equal_and_composes():
    gj, gt = graphs("clustered")
    rng = np.random.default_rng(5)
    o1, o2 = rng.permutation(gt.n_node), rng.permutation(gt.n_node)
    pj, pt = jreo.permute_graph(gj, o1), treo.permute_graph(gt, o1)
    assert_same_graph(pj, pt)
    pj, pt = jreo.permute_graph(pj, o2), treo.permute_graph(pt, o2)
    assert_same_graph(pj, pt)
    np.testing.assert_array_equal(pt.node_perm.numpy(), o1[o2])


def test_relabel_and_run_cog_equal(tmp_path):
    gj, gt = graphs("clustered")
    part = tcom.detect_communities(gt)
    (rj, bj), (rt, bt) = jcom.relabel_communities(gj, part), tcom.relabel_communities(gt, part)
    assert bt == bj
    assert_same_graph(rj, rt)
    cj, bookj, _ = jcom.run_cog(gj, hbm_budget_bytes=1 << 14, batch_size=256)
    ct, book, timings = tcom.run_cog(gt, hbm_budget_bytes=1 << 14, batch_size=256)
    assert book == bookj and set(timings) == {"detect", "merge_split", "relabel"}
    assert_same_graph(cj, ct)

    path = tmp_path / "book.json"
    tcom.save_community_book(book, str(path))
    assert tcom.load_community_book(str(path)) == jcom.load_community_book(str(path)) == book
    assert json.loads(path.read_text()) == {str(k): v for k, v in book.items()}
    cid = next(iter(book))
    lo, hi = book[cid]
    assert torch.equal(tcom.community_feature_slice(ct.node_feat, book, cid),
                       ct.node_feat[lo:hi])


@pytest.mark.parametrize("min_fraction", [None, 0.5, 0.99])
@pytest.mark.parametrize("name", ["shuffled", "expander"])
def test_reorder_for_locality_equal(name, min_fraction):
    gj, gt = graphs(name)
    rj, ij = jreo.reorder_for_locality(gj, min_fraction=min_fraction)
    rt, it = treo.reorder_for_locality(gt, min_fraction=min_fraction)
    strip = lambda info: {k: v for k, v in info.items() if not k.endswith("_s")}  # noqa: E731
    assert strip(it) == strip(ij)
    assert (rt is gt) == (rj is gj)
    assert_same_graph(rj, rt)


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_with_windowed_decides_as_jax(name, reorder):
    """Attach, decline (returning the caller's graph itself), or relabel then attach:
    the same choice, the same fractions and the same node order as the JAX package."""
    gj, gt = graphs(name)
    wj, wt = gj.with_windowed(reorder=reorder), gt.with_windowed(reorder=reorder)
    assert (wt.hybrid is None) == (wj.hybrid is None)
    assert (wt is gt) == (wj is gj) == (wt.hybrid is None)
    if wt.hybrid is not None:
        assert (wt.hybrid.windowed_fraction, wt.hybrid_t.windowed_fraction) == (
            wj.hybrid.windowed_fraction, wj.hybrid_t.windowed_fraction)
    assert_same_graph(wj, wt)
    expect = {"clustered": "attach", "spread": "decline", "expander": "decline",
              "shuffled": "relabel" if reorder else "decline"}[name]
    got = ("decline" if wt.hybrid is None
           else "relabel" if wt.node_perm is not None else "attach")
    assert got == expect


def test_cli_attaches_windowed_where_it_pays():
    """The CLI's choice of layouts (``run.attach_kernel_layouts``): GCN takes the
    windowed layouts on a clustered graph and K1 alone where they decline; GAT
    takes the chunked ones only."""
    from dgll_tpu_torch import run
    from dgll_tpu_torch.nn import GATConv
    from dgll_tpu_torch.utils import parse_train_config

    _, gt = graphs("shuffled")
    gcn, gat = (run.build_model(parse_train_config(["--Model", m, "--samp_type", "full"]),
                                3, gt.node_feat.shape[1]) for m in ("GCN", "GAT"))
    g, extra = run.attach_kernel_layouts(gcn, gt)
    assert g.hybrid is not None and g.chunked is not None
    assert extra["spmm_kernel"] == run.WINDOWED_KERNEL and extra["locality_reordered"]
    g, extra = run.attach_kernel_layouts(gat, gt)
    assert g.hybrid is None and g.chunked is not None and g is not gt
    assert extra["spmm_kernel"] == run.SPMM_KERNEL and "locality_reordered" not in extra
    assert extra["gat_kernel"] == GATConv.REPORTS["gat_kernel"] == "gat_attention_fused"
    _, gt = graphs("expander")
    g, extra = run.attach_kernel_layouts(gcn, gt)
    assert g.hybrid is None and g.chunked is not None and g.node_perm is None
    assert extra["spmm_kernel"] == run.SPMM_KERNEL and extra["layout_preprocess_s"] >= 0


def test_remap_matches_numpy():
    rng = np.random.default_rng(6)
    mapping, idx = rng.permutation(1000), rng.integers(0, 1000, 5000)
    np.testing.assert_array_equal(native.remap(mapping, idx), mapping[idx])
