"""SAGE's mean and sum on a full ``Graph`` through kernel K1 (``SAGEConv._aggregate``),
on layouts built from the graph's edges on its device (``Graph.mean_chunked``,
``Graph.sum_chunked``, through ``ops/chunked.py:build_chunked_pair``).

The pair equals a host lexsort build over every edge of the graph (duplicates,
self-loops, rows without in-edges, a row that K1 splits, a padded graph), with the
mean's ``1 / deg`` or the sum's edge weights on each edge in both orders, and its
``t_slot_perm``. On the CPU ``spmm_chunked`` runs its plain version, so the route's output and
its ``x`` gradient are held to the COO composition (``spmm_mean_coo`` / ``spmm_coo``
with autograd) to float32 rounding; ``max`` and the blocks keep their paths.

The card test (marker ``card``; this file imports no JAX, so it runs on the machine
with the card, where ``tests/conftest.py`` cannot load):
``python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_sage_k1.py``.
"""
import numpy as np
import pytest
import torch

from dgll_tpu_torch.graph import Graph, pad_graph
from dgll_tpu_torch.nn import GraphSAGE, SAGEConv
from dgll_tpu_torch.ops.chunked import R_BLOCK, SPLIT_EDGES
from dgll_tpu_torch.ops.spmm import spmm_coo, spmm_mean_coo
from dgll_tpu_torch.sampling import HostGraph, NeighborSampler
from dgll_tpu_torch.sampling.base import SparseBlock
from dgll_tpu_torch.utils import profiling

N = 300
HUB = 7            # the row of more than SPLIT_EDGES in-edges
NO_IN = (0, 299)   # rows that no edge reaches


def _graph(case: str, n: int = N, seed: int = 0) -> Graph:
    """A weighted power-law graph with a hub row, rows without in-edges, and the
    case's feature: duplicate edges, self-loops, or padding (``pad_graph``)."""
    rng = np.random.default_rng(seed)
    e = 8 * n
    src = rng.integers(0, n, e)
    dst = 1 + (rng.pareto(1.0, e) * 3).astype(np.int64) % (n - 2)
    src = np.concatenate([src, rng.integers(0, n, SPLIT_EDGES + 250)])
    dst = np.concatenate([dst, np.full(SPLIT_EDGES + 250, HUB)])
    if case == "duplicates":  # the same pair three times, with other weights
        src = np.concatenate([src, [5, 5, 5, 9, 9]])
        dst = np.concatenate([dst, [4, 4, 4, HUB, HUB]])
    w = rng.random(src.size).astype(np.float32) + 0.5
    g = Graph.from_edges(src, dst, n, edge_weight=w,
                         add_self_loops=case == "self_loops")
    return pad_graph(g) if case == "padded" else g


CASES = ["duplicates", "self_loops", "no_in_edges", "padded"]


def _lexsort_layout(src, dst, n_rows, w):
    """A layout as a host lexsort builds it: edges by (dst, src), duplicates in their
    input order, the row space padded to ``R_BLOCK``."""
    order = np.lexsort((src, dst))
    n_pad = -(-n_rows // R_BLOCK) * R_BLOCK
    indptr = np.zeros(n_pad + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n_pad), out=indptr[1:])
    return {"indptr": indptr.astype(np.int32), "src": src[order].astype(np.int32),
            "rows": dst[order].astype(np.int32), "weight": w[order], "n_rows": n_pad}


def _layouts(g, kind):
    return g.mean_chunked if kind == "mean" else g.sum_chunked


@pytest.mark.parametrize("kind", ["mean", "sum"])
@pytest.mark.parametrize("case", CASES)
def test_graph_layouts_equal_a_lexsort_build(case, kind):
    g = _graph(case)
    deg = (g.indptr[1:] - g.indptr[:-1]).clamp_min(1).float()
    src, dst = g.src.numpy().astype(np.int64), g.dst.numpy().astype(np.int64)
    w = ((1.0 / deg)[g.dst.long()] if kind == "mean" else g.edge_weight).numpy()
    got = _layouts(g, kind)
    assert _layouts(g, kind) is got  # kept on the instance
    for lay, want in zip(got, (_lexsort_layout(src, dst, g.n_node, w),
                               _lexsort_layout(dst, src, g.n_node, w))):
        for f in ("indptr", "src", "rows", "weight"):
            assert getattr(lay, f).dtype == torch.from_numpy(want[f]).dtype, f
            np.testing.assert_array_equal(getattr(lay, f).numpy(), want[f], err_msg=f)
        assert (lay.n_rows, lay.n_cols) == (want["n_rows"], g.n_node)
        assert lay.src.numel() == g.n_edge  # every edge, padded ones included
    a, at = got
    # t_slot_perm: A^T's edge j is A's edge t_slot_perm[j]
    np.testing.assert_array_equal(a.t_slot_perm.numpy(),
                                  np.lexsort((a.rows.numpy(), a.src.numpy())))
    assert a.split.n_split >= 1  # the hub row is cut into segments
    if kind == "mean":  # each edge's weight in both orders: 1/deg(dst)
        assert torch.equal(a.weight, 1.0 / deg[a.rows.long()])
        assert torch.equal(at.weight, 1.0 / deg[at.src.long()])
    if case == "padded":
        assert g.n_edge > g.n_real_edge and g.n_node > g.n_real_node


def _coo(kind, g, x):
    if kind == "mean":
        return spmm_mean_coo(g.src, g.dst, x, g.n_node)
    return spmm_coo(g.src, g.dst, x, g.n_node, g.edge_weight)


def _close(got, want):
    scale = max(want.abs().max().item(), 1.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("kind", ["mean", "sum"])
@pytest.mark.parametrize("case", CASES)
def test_route_matches_the_coo_composition(case, kind):
    g = _graph(case)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(g.n_node, 6, generator=gen)
    cot = torch.randn(g.n_node, 6, generator=gen)
    conv = SAGEConv(6, 4, kind)
    xk = x.clone().requires_grad_(True)
    with profiling.tracing():
        profiling.reset()
        got = conv._aggregate(g, xk, g.n_node)
    assert profiling.report()["counters"] == {"conv.aggregate_k1": 1}
    (got * cot).sum().backward()
    xc = x.clone().requires_grad_(True)
    want = _coo(kind, g, xc)
    (want * cot).sum().backward()
    assert got.shape == want.shape == (g.n_node, 6)
    _close(got.detach(), want.detach())
    _close(xk.grad, xc.grad)
    for r in NO_IN:
        if case != "self_loops":
            assert not got[r].any()


def test_bf16_mean_is_one_rounding_from_exact_unlike_a_bf16_sum():
    """K1 sums bfloat16 messages in float32 and rounds once; the COO composition in
    bfloat16 (the JAX package's mean, and this port's before K1) rounds at every
    add, which over the hub's hundreds of positive messages drifts far more."""
    g = _graph("self_loops")
    x = (torch.rand(g.n_node, 8, generator=torch.Generator().manual_seed(4)) + 1.0
         ).to(torch.bfloat16)
    exact = spmm_mean_coo(g.src, g.dst, x.double(), g.n_node)
    got = SAGEConv(8, 4, "mean")._aggregate(g, x, g.n_node)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** -7 * exact.abs()  # bf16 keeps 8 significant bits
    assert ((got.double() - exact).abs() <= ulp).all()
    drift = (spmm_mean_coo(g.src, g.dst, x, g.n_node).double() - exact).abs()
    assert (drift[HUB] > 4 * ulp[HUB]).any()


def test_counter_counts_one_a_layer_and_the_step_trains():
    g = _graph("padded")
    x = torch.randn(g.n_node, 6, generator=torch.Generator().manual_seed(2))
    model = GraphSAGE(6, 8, 3, n_layers=3, dropout=0.0,
                      generator=torch.Generator().manual_seed(0))
    profiling.reset()
    with profiling.tracing():
        loss = model(g, x)[:, 0].sum()
    loss.backward()
    assert profiling.report()["counters"] == {"conv.aggregate_k1": 3}
    assert all(p.grad is not None and p.grad.abs().sum() > 0
               for p in model.parameters())
    profiling.reset()


def _sparse_block() -> SparseBlock:
    ids = torch.tensor([0, 1, 2], dtype=torch.int32)
    mask = torch.ones(3, dtype=torch.bool)
    return SparseBlock(dst_ids=ids[:1], src_ids=ids,
                       src=torch.tensor([1, 2, 0], dtype=torch.int32),
                       dst=torch.tensor([0, 0, 0], dtype=torch.int32),
                       edge_weight=torch.tensor([0.5, 0.25, 0.0]), dst_mask=mask[:1],
                       src_mask=mask, n_dst=1, n_src=3, n_edge=3)


@pytest.mark.parametrize("what", ["max", "block", "sparse_block"])
def test_max_and_the_blocks_keep_their_paths(what):
    g = _graph("no_in_edges")
    if what == "block":
        _, _, blocks = NeighborSampler([4], seed=0).sample(
            HostGraph.from_graph(g), np.arange(16), pad_to=16)
        b = blocks[0]
    elif what == "sparse_block":
        b = _sparse_block()
    else:
        b = g
    x = torch.randn(b.n_src if what != "max" else g.n_node, 5)
    profiling.reset()
    with profiling.tracing():
        out = SAGEConv(5, 3, "max" if what == "max" else "mean")(b, x)
    assert out.shape[0] == (g.n_node if what == "max" else b.n_dst)
    assert profiling.report()["counters"] == {}
    assert not {"mean_chunked", "sum_chunked"} & set(g.__dict__)
    profiling.reset()


def test_replace_and_to_build_anew():
    g = _graph("duplicates")
    a, _ = g.sum_chunked
    g2 = g.replace(edge_weight=2 * g.edge_weight)
    assert torch.equal(g2.sum_chunked[0].weight, 2 * a.weight)
    assert g.to("cpu").sum_chunked[0] is not a
    assert g.mean_chunked[0] is not a


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the machine with the H100")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [128, 512])
def test_route_through_the_kernel_on_the_card(card, width, dtype):
    """K1 against the COO composition in float32 on the same (rounded) input, with a
    hub row over 512 edges: float32 to its rounding, bfloat16 to a few of its ulps."""
    from dgll_tpu_torch.ops.cuda import segment_matmul as sm

    g = _graph("padded", n=20_000).to(card)
    gen = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(g.n_node, width, device=card, generator=gen).to(dtype)
    cot = torch.randn(g.n_node, width, device=card, generator=gen)
    tol = 1e-5 if dtype == torch.float32 else 1.6e-2
    for kind in ("mean", "sum"):
        xk = x.clone().requires_grad_(True)
        fwd, bwd = sm.launches_fwd, sm.launches_bwd
        got = SAGEConv(width, 4, kind, device=card)._aggregate(g, xk, g.n_node)
        (got.float() * cot).sum().backward()
        assert (sm.launches_fwd - fwd, sm.launches_bwd - bwd) == (1, 1)
        assert got.dtype == xk.grad.dtype == dtype
        xc = x.float().clone().requires_grad_(True)
        want = _coo(kind, g, xc)
        (want * cot.to(dtype).float()).sum().backward()
        for a, b in ((got.float(), want), (xk.grad.float(), xc.grad)):
            scale = max(b.abs().max().item(), 1.0)
            torch.testing.assert_close(a, b.detach(), rtol=tol, atol=tol * scale)


@pytest.mark.card
def test_a_two_layer_step_launches_k1_twice_forward_once_backward(card):
    from dgll_tpu_torch.ops.cuda import segment_matmul as sm

    g = _graph("self_loops", n=20_000).to(card)
    x = torch.randn(g.n_node, 128, device=card)  # the features need no gradient
    model = GraphSAGE(128, 256, 40, n_layers=2, dropout=0.0, device=card,
                      generator=torch.Generator().manual_seed(0))
    fwd, bwd = sm.launches_fwd, sm.launches_bwd
    model(g, x)[:, 0].sum().backward()
    torch.cuda.synchronize()
    assert (sm.launches_fwd - fwd, sm.launches_bwd - bwd) == (2, 1)
