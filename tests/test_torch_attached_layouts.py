"""The layouts a model's layers declare (``nn.conv.attached_layouts``) decide what the
CLI attaches (``run.attach_kernel_layouts``): for every model as ``run.build_model``
builds it, on a graph that the windowed layout takes after a relabelling and on one
where it declines, exactly the layouts and the report keys that the CLI's former
table by model name gave: GCN and GIN ``with_windowed(reorder=True).with_chunked()``,
GAT ``with_chunked()`` and ``gat_kernel``, GraphSAGE and GCNII nothing.

This file imports no JAX.
"""
import numpy as np
import pytest
import torch

from dgll_tpu_torch import run
from dgll_tpu_torch.data import gcn_normalize
from dgll_tpu_torch.graph import Graph
from dgll_tpu_torch.utils import parse_train_config


def _graph(kind: str) -> Graph:
    """A clustered graph with shuffled ids (the windowed layout attaches once the
    nodes are relabelled) or a uniform one (it declines), with self-loops."""
    rng = np.random.default_rng(8)
    n, e = 8192, 8192 * 3
    dst = rng.integers(0, n, e)
    if kind == "shuffled":
        csize = n // 8
        src = np.where(rng.random(e) < 0.95,
                       (dst // csize) * csize + rng.integers(0, csize, e),
                       rng.integers(0, n, e)) % n
        relabel = rng.permutation(n)
        src, dst = relabel[src], relabel[dst]
    else:
        src = rng.integers(0, n, e)
    feats = rng.standard_normal((n, 6)).astype(np.float32)
    return gcn_normalize(Graph.from_edges(src, dst, n, node_feat=feats,
                                          add_self_loops=True))


def _by_model_name(model_name: str, g: Graph):
    """The CLI's choice before the layers declared it: a table by model name."""
    name = model_name.upper()
    if name in ("GRAPHSAGE", "SAGE", "GCNII"):
        return g, {}
    extra = {}
    if name == "GAT":
        g = g.with_chunked()
        extra["gat_kernel"] = "gat_attention_fused"
    else:
        g = g.with_windowed(reorder=True).with_chunked()
    extra["spmm_kernel"] = run.SPMM_KERNEL if g.hybrid is None else run.WINDOWED_KERNEL
    if g.node_perm is not None:
        extra["locality_reordered"] = True
    return g, extra


def _layout_fields(g: Graph) -> dict:
    out = {"node_perm": g.node_perm, "edge_weight": g.edge_weight}
    for name in ("chunked", "chunked_t"):
        lay = getattr(g, name)
        out[name] = None if lay is None else (lay.indptr, lay.src, lay.weight)
    for name in ("hybrid", "hybrid_t"):
        lay = getattr(g, name)
        out[name] = None if lay is None else lay.windowed_fraction
    return out


def _assert_same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("kind", ["shuffled", "uniform"])
@pytest.mark.parametrize("model_name", ["GCN", "GIN", "GAT", "GraphSAGE", "GCNII"])
def test_declared_layouts_attach_what_the_model_table_did(model_name, kind):
    g = _graph(kind)
    cfg = parse_train_config(["--Model", model_name, "--samp_type", "full",
                              "--n_layers", "2", "--nhid", "8"])
    model = run.build_model(cfg, 3, g.node_feat.shape[1])
    got, extra = run.attach_kernel_layouts(model, g)
    want, want_extra = _by_model_name(model_name, g)
    if not want_extra:
        assert got is g and extra == {}
        return
    assert extra.pop("layout_preprocess_s") >= 0
    assert extra == want_extra
    have, need = _layout_fields(got), _layout_fields(want)
    assert have.keys() == need.keys()
    for k in need:
        assert (have[k] is None) == (need[k] is None), k
        if need[k] is not None:
            _assert_same(have[k], need[k])
    if model_name in ("GCN", "GIN"):  # both graphs take their own branch of the table
        assert (got.hybrid is not None) == (kind == "shuffled")
        assert (got.node_perm is not None) == (kind == "shuffled")
