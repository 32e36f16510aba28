"""K6's split of long rows and K10's width-1 rows-to-edges mapping, on the CPU.

K6 (``csrc/gat_csr.cu``: ``edges_to_rows_kernel`` and ``combine_segments_kernel``,
sum and max) runs on the layout's split schedule (``c.split``, K1's), as K3 and K5
do: a lane group a row of at most T edges and a lane group a segment of a longer
row, whose per-head sum or max a second pass combines in segment order. K10's
rows-to-edges (``rows_to_edges_kernel``) gives each thread 4 consecutive edges and
the first block's threads the last nnz % 4.

* A plain PyTorch version of K6 that follows the kernel's schedule and lanes (items
  from ``split_schedule``, lane groups of ``item_lanes(H)``, each lane's values in
  edge order, the xor-shuffle tree, pass 2 in segment order), in its sum and max
  modes, on the planted graph of ``tests/test_torch_spmm_split.py`` (rows of degree
  0, 1, T-1, T, T+1, 2T, 2T+1 and 10T+3, an edgeless 128-row block) at T=8 and
  T=512, H in {1, 3, 8}, against ``edges_to_rows_sum_reference`` /
  ``edges_to_rows_max_reference`` and JAX's ``_edges_to_rows_multi_impl`` (and, at
  H=1, ``_edges_to_rows``) in interpret mode (128-slot chunks).
* K10's mapping of edges to threads: every edge exactly once for nnz % 4 in
  {0, 1, 2, 3}; its plain result equal to JAX's ``rows_to_edges`` (interpret) and to
  the port's wrapper.

Tolerance (f32): maxima exactly equal (a max does not round); sums within rtol 1e-5
and atol 1e-5 x max|ref| (the sides sum in different orders, over up to 5,123 terms
a row). The kernels are held to the same bars on the card by ``chip_smoke.py``
(the max exact, the sum within 1e-4 x max|ref|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu.ops.pallas import edge_ops as je
from dgll_tpu_torch.ops import gat_csr
from dgll_tpu_torch.ops.chunked import SPLIT_EDGES
from dgll_tpu_torch.ops.cuda import edge_ops as tk
from test_torch_edge_ops import _edges, _meta, _thread_pool  # noqa: F401 (fixture)
from test_torch_gat import _to_slots
from test_torch_gat_split import graph, group_reduce, items, layouts_of, schedule, split_rows
from test_torch_spmm_split import assert_close, planted_graph

HEADS = [1, 3, 8]
OPS = {"sum": (0.0, torch.add, gat_csr.edges_to_rows_sum_reference),
       "max": (gat_csr.NEG, torch.maximum, gat_csr.edges_to_rows_max_reference)}


def edges_to_rows_split(c, sp, v, op):
    """K6 as the kernel computes it, ``[n_rows, H]``: pass 1 reduces each item in its
    lane group (a row's output, a segment's partial; a row without edges gets the
    identity), pass 2 combines a split row's partials in segment order."""
    ident, comb, _ = OPS[op]
    h = v.shape[1]
    out, partial = torch.empty(c.n_rows, h), torch.empty(sp.n_seg, h)
    for seg, row, b, end in items(c, sp):
        if seg is None:
            out[row] = group_reduce(v[b:end], op)
        else:
            partial[seg] = group_reduce(v[b:end], op)
    for row, segs in split_rows(sp):
        s = torch.full((h,), ident)
        for p in segs:
            s = comb(s, partial[p])
        out[row] = s
    return out


def _agree(op, got, want):
    if op == "max":
        np.testing.assert_array_equal(got, want)
    else:
        assert_close(got, want)


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("t", [8, SPLIT_EDGES])
@pytest.mark.parametrize("op", sorted(OPS))
def test_edges_to_rows_split_matches_reference_and_jax(op, t, heads):
    jc, c, slots = graph(t)
    v = _edges(c, heads, 20 + t + heads)
    got = edges_to_rows_split(c, schedule(c, t), torch.from_numpy(v), op)
    _agree(op, got.numpy(), OPS[op][2](c, torch.from_numpy(v)).numpy())
    want = je._edges_to_rows_multi_impl(jc, _to_slots(jc, slots, v), op, True)
    _agree(op, got.numpy(), np.asarray(want))
    if heads == 1:  # K10's single-head reduction runs the same kernel
        want = je._edges_to_rows(jc, _meta(jc, slots, v[:, 0]), op, True)
        _agree(op, got[:, 0].numpy(), np.asarray(want))
    empty = np.diff(c.indptr.numpy()) == 0
    assert empty[0] and empty[128:256].all()
    assert (got[empty] == OPS[op][0]).all()


def rows_to_edges_threads(nnz: int) -> list:
    """The edges of each thread of K10's rows-to-edges kernel, in thread order:
    thread q < nnz // 4 takes edges 4q .. 4q+3; then the first block's threads
    0 .. nnz % 4 - 1 take one each of the last edges."""
    quads = nnz >> 2
    return ([list(range(4 * q, 4 * q + 4)) for q in range(quads)]
            + [[4 * quads + j] for j in range(nnz & 3)])


def rows_to_edges_by_threads(c, a):
    """K10's rows-to-edges as the kernel's threads compute it: ``out[e] = a[rows[e]]``
    over each thread's edges."""
    out = torch.empty(c.src.numel())
    for edges in rows_to_edges_threads(c.src.numel()):
        out[edges] = a[c.rows[edges].long()]
    return out


@pytest.mark.parametrize("rem", [0, 1, 2, 3])
def test_rows_to_edges_threads_cover_every_edge_once(rem):
    for nnz in (rem, 4 + rem, 4 * 257 + rem):
        edges = [e for thread in rows_to_edges_threads(nnz) for e in thread]
        assert sorted(edges) == list(range(nnz)) and len(edges) == nnz


@pytest.mark.parametrize("rem", [0, 1, 2, 3])
def test_rows_to_edges_width1_matches_jax(rem):
    """On the planted graph (T=8) cut to a length with ``nnz % 4 == rem``."""
    src, dst, _ = planted_graph(8)
    m = len(src) - (len(src) - rem) % 4
    jc, c, slots = layouts_of(src[:m], dst[:m])
    assert c.src.numel() == m and m % 4 == rem
    a = np.random.default_rng(rem).normal(size=c.n_rows).astype(np.float32)
    got = rows_to_edges_by_threads(c, torch.from_numpy(a))
    want = np.asarray(je.rows_to_edges(jc, jnp.asarray(a), interpret=True)).reshape(-1)
    np.testing.assert_array_equal(got.numpy(), want[slots])
    assert torch.equal(got, tk.rows_to_edges(c, torch.from_numpy(a)))


def test_rows_to_edges_launcher_takes_cuda_tensors_only():
    """A CPU tensor never reaches K10's launcher; the wrapper runs the plain version
    and counts no launch."""
    _, c, _ = graph(8)
    a = torch.ones(c.n_rows)
    with pytest.raises(ValueError, match="CUDA"):
        tk.rows_to_edges_cuda(c, a)
    before = dict(tk.launches)
    tk.rows_to_edges(c, a)
    assert tk.launches == before
