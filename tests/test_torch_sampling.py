"""Parity of the port's neighbour sampler and data loader with the JAX package's.

Both packages build the same C++ sampler, draw each batch's seed from the same numpy
``Generator`` and shuffle with ``default_rng(seed).permutation``, so their blocks are
equal bit for bit, batch by batch. Tolerance: none. The per-layer path (the
fallback without the fused sampler) draws through ``dgll_sample_neighbors``, whose
stream depends on the core count, so it is compared within this one process.
"""
import numpy as np
import pytest
import torch

from dgll_tpu import native as jax_native
from dgll_tpu.data import synthetic_classification_graph as jax_synthetic
from dgll_tpu.dataloader import DataLoader as JaxDataLoader
from dgll_tpu.sampling import CommunityNeighborSampler as JaxCommunitySampler
from dgll_tpu.sampling import HostGraph as JaxHostGraph
from dgll_tpu.sampling import NeighborSampler as JaxSampler
from dgll_tpu_torch import native
from dgll_tpu_torch.data import synthetic_classification_graph
from dgll_tpu_torch.dataloader import DataLoader
from dgll_tpu_torch.sampling import (
    Block,
    CommunityNeighborSampler,
    DGLLNeighborSampler,
    HostGraph,
    NeighborSampler,
    sample_neighbors_padded,
)
from test_torch_edge_ops import _thread_pool  # noqa: F401 (fixture)

GRAPH = dict(n_node=400, avg_degree=6, n_class=4, feat_dim=8, power_law=1.0, seed=2)


@pytest.fixture(scope="module")
def graphs():
    gt, gj = synthetic_classification_graph(**GRAPH), jax_synthetic(**GRAPH)
    ht, hj = HostGraph.from_graph(gt), JaxHostGraph.from_graph(gj)
    np.testing.assert_array_equal(ht.indptr, hj.indptr)
    np.testing.assert_array_equal(ht.src, hj.src)
    assert ht.n_node == hj.n_node
    return gt, gj, ht, hj


def _same_blocks(bt, bj):
    assert len(bt) == len(bj)
    for t, j in zip(bt, bj):
        assert isinstance(t, Block)
        assert (t.fanout, t.n_dst, t.n_src, t.n_edge) == (j.fanout, j.n_dst, j.n_src, j.n_edge)
        for name in ("dst_ids", "src_ids", "neigh_mask", "dst_mask"):
            a, b = getattr(t, name), np.asarray(getattr(j, name))
            assert a.dtype == {np.dtype(np.int32): torch.int32,
                               np.dtype(bool): torch.bool}[b.dtype], name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        np.testing.assert_array_equal(t.src.numpy(), np.asarray(j.src))
        np.testing.assert_array_equal(t.dst.numpy(), np.asarray(j.dst))
        np.testing.assert_array_equal(t.edge_weight.numpy(), np.asarray(j.edge_weight))


def _same_batches(st, sj, ht, hj, pad_to=None, n_batches=4):
    rng = np.random.default_rng(5)
    for _ in range(n_batches):
        seeds = rng.choice(ht.n_node, 37, replace=False)
        it, ot, bt = st.sample(ht, seeds, pad_to=pad_to)
        ij, oj, bj = sj.sample(hj, seeds, pad_to=pad_to)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(ot, oj)
        assert it.dtype == np.int64
        _same_blocks(bt, bj)


@pytest.mark.parametrize("fanouts", [[3, 2], [5], [4, 3, 2]])
@pytest.mark.parametrize("pad_to", [None, 48])
def test_fused_blocks_match_jax(graphs, fanouts, pad_to):
    _, _, ht, hj = graphs
    assert native.native_available() and jax_native.native_available()
    _same_batches(NeighborSampler(fanouts, seed=3), JaxSampler(fanouts, seed=3), ht, hj,
                  pad_to)


@pytest.mark.parametrize("fanouts", [[3, 2], [4, 3, 2]])
def test_per_layer_blocks_match_jax(graphs, fanouts, monkeypatch):
    """Without the fused sampler both packages take the per-layer path."""
    _, _, ht, hj = graphs
    monkeypatch.setattr(native, "sample_block_fused", lambda *a, **k: None)
    monkeypatch.setattr(jax_native, "sample_block_fused", lambda *a, **k: None)
    _same_batches(NeighborSampler(fanouts, seed=4), JaxSampler(fanouts, seed=4), ht, hj, 40)


def test_sample_neighbors_padded_and_numpy_fallback_match_jax(graphs, monkeypatch):
    _, _, ht, hj = graphs
    from dgll_tpu.sampling import sample_neighbors_padded as jax_padded

    ids = np.arange(0, 400, 7)
    mask = ids % 3 != 0
    a = sample_neighbors_padded(ht, ids, mask, 4, np.random.default_rng(1))
    b = jax_padded(hj, ids, mask, 4, np.random.default_rng(1))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    assert native.sample_block_fused(ht.indptr, ht.src, ids, mask, [2], 0) is None
    for x, y in zip(native.sample_neighbors(ht.indptr, ht.src, ids, mask, 5, 9),
                    jax_native.sample_neighbors(hj.indptr, hj.src, ids, mask, 5, 9)):
        np.testing.assert_array_equal(x, y)


def test_community_sampler_matches_jax_and_stays_in_range(graphs):
    _, _, ht, hj = graphs
    lo, hi = 100, 260
    st = CommunityNeighborSampler([4, 3], (lo, hi), seed=1)
    sj = JaxCommunitySampler([4, 3], (lo, hi), seed=1)
    rng = np.random.default_rng(0)
    for _ in range(3):
        seeds = rng.choice(np.arange(lo, hi), 20, replace=False)
        it, _, bt = st.sample(ht, seeds, pad_to=24)
        _, _, bj = sj.sample(hj, seeds, pad_to=24)
        _same_blocks(bt, bj)
        assert it.min() >= lo and it.max() < hi
    with pytest.raises(ValueError, match="outside the community"):
        st.sample(ht, np.array([lo - 1]))


def test_sample_packed_matches_blocks_and_jax(graphs):
    _, _, ht, hj = graphs
    fanouts = [3, 2]
    seeds = np.arange(10, 30)
    ids, mask = NeighborSampler(fanouts, seed=6).sample_packed(ht, seeds, pad_to=24)
    ij, mj = JaxSampler(fanouts, seed=6).sample_packed(hj, seeds, pad_to=24)
    np.testing.assert_array_equal(ids, ij)
    np.testing.assert_array_equal(mask, mj)
    assert NeighborSampler.packed_sizes(24, fanouts) == [24, 72, 288] == [
        int(s) for s in JaxSampler.packed_sizes(24, fanouts)]
    _, _, blocks = NeighborSampler(fanouts, seed=6).sample(ht, seeds, pad_to=24)
    np.testing.assert_array_equal(blocks[0].src_ids.numpy(), ids)
    np.testing.assert_array_equal(blocks[0].neigh_mask.numpy().reshape(-1),
                                  mask[72:].view(bool))
    assert DGLLNeighborSampler is NeighborSampler


def test_block_moves_to_a_device(graphs):
    _, _, ht, _ = graphs
    _, _, blocks = NeighborSampler([3], seed=0).sample(ht, np.arange(8))
    b = blocks[0].to("cpu")
    assert b.src_ids.device.type == "cpu" and b.neigh_mask.dtype == torch.bool
    assert (b.num_src_nodes, b.num_dst_nodes) == (32, 8)


def _loader_batches(loader):
    return [(inp.copy(), out.copy(), [np.asarray(b.src_ids).copy() for b in blocks])
            for inp, out, blocks in loader]


@pytest.mark.parametrize("kw", [
    dict(shuffle=False),
    dict(shuffle=True),
    dict(shuffle=True, drop_last=True),
    dict(shuffle=True, prefetch=0),
    dict(shuffle=True, num_shards=3, shard_index=1),
])
def test_dataloader_order_matches_jax(graphs, kw):
    gt, gj, _, _ = graphs
    seeds = gt.get_train_nodes()
    np.testing.assert_array_equal(seeds, np.asarray(gj.get_train_nodes()))
    lt = DataLoader(gt, seeds, NeighborSampler([3, 2], seed=1), 16, seed=2, **kw)
    lj = JaxDataLoader(gj, seeds, JaxSampler([3, 2], seed=1), 16, seed=2, **kw)
    assert len(lt) == len(lj) > 0
    for _ in range(2):  # two epochs: the permutation moves on
        bt, bj = _loader_batches(lt), _loader_batches(lj)
        assert len(bt) == len(bj) == len(lt)
        for (it, ot, st), (ij, oj, sj) in zip(bt, bj):
            np.testing.assert_array_equal(ot, oj)
            np.testing.assert_array_equal(it, ij)
            for a, b in zip(st, sj):
                np.testing.assert_array_equal(a, b)


def test_dataloader_producers_and_device(graphs):
    gt, _, _, _ = graphs
    seeds = np.arange(100)
    one = DataLoader(gt, seeds, NeighborSampler([2], seed=0), 10, shuffle=False)
    many = DataLoader(gt, seeds, NeighborSampler([2], seed=0), 10, shuffle=False,
                      n_producers=3, device="cpu")
    outs = sorted(tuple(out) for _, out, _ in many)
    assert outs == sorted(tuple(out) for _, out, _ in one)
    assert all(b.src_ids.device.type == "cpu" for _, _, bl in many for b in bl)
    packed = list(DataLoader(gt, seeds, NeighborSampler([2], seed=0), 10, shuffle=False,
                             packed=True, n_producers=3, device="cpu"))
    assert len(packed) == 10
    assert all(ids.dtype == torch.int32 and mask.dtype == torch.uint8
               and ids.shape == mask.shape == (30,) for ids, mask in packed)
    assert sorted(tuple(ids[:10].tolist()) for ids, _ in packed) == outs


def test_split_node_ids_match_jax(graphs):
    gt, gj, _, _ = graphs
    for name in ("get_train_nodes", "get_validation_nodes", "get_test_nodes"):
        a, b = getattr(gt, name)(), np.asarray(getattr(gj, name)())
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
